"""Algorithm layer of the port: graph, quantizer, censor, solvers,
topology and the consensus engine."""
