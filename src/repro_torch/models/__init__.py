"""Language models of the ported consensus-training path (xLSTM)."""
