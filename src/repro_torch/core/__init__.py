"""Algorithm layer of the port: graph, quantizer, censor, solvers,
topology, the consensus engine and the time-varying topology."""
from repro_torch.core.dynamic import DynamicTopology, run_dynamic

__all__ = ["DynamicTopology", "run_dynamic"]
