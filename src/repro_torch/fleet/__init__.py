"""Fleet simulation: stragglers, bounded staleness, churn (DESIGN.md
§Fleet), traced with ``--trace`` (``FleetSim.run``)."""
from repro_torch.fleet.faults import (ChurnEvent, FaultConfig, FaultSchedule,
                                      RoundFaults, staleness_trace)
from repro_torch.fleet.sim import (FleetConfig, FleetSim, FleetState,
                                   init_fleet_state, make_fleet_step,
                                   remap_fleet_state, run_synchronous,
                                   stack_records)

__all__ = [
    "ChurnEvent", "FaultConfig", "FaultSchedule", "RoundFaults",
    "staleness_trace", "FleetConfig", "FleetSim", "FleetState",
    "init_fleet_state", "make_fleet_step", "remap_fleet_state",
    "run_synchronous", "stack_records",
]
