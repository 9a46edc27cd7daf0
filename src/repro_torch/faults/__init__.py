"""Declarative fault injection + chaos campaigns for the ABFT stack.

``model`` declares WHAT goes wrong (site x kind x timing), ``injectors``
makes it happen (bitcast bit-flips, sticky re-application, the kernel
accumulator hook), ``selfcheck`` guards the check path itself (periodic
re-derivation of the eq.-5 fold and the staged s_c), and ``campaign``
sweeps the grid and measures detection / SDC / false-positive rates plus
the guard's repair-tier distribution.  Counterpart of the JAX package's
``repro/faults``.
"""
from repro_torch.faults.campaign import (ExperimentResult, run_experiment,
                                         run_fault_campaign)
from repro_torch.faults.injectors import FaultInjector, flip_bits
from repro_torch.faults.model import (CHECK_PATH_SITES, CONSISTENT_SITES,
                                      KINDS, SITES, TIMINGS, FaultModel,
                                      sweep_models)
from repro_torch.faults.selfcheck import (CheckPathSelfCheck, refold,
                                          verify_s_c, verify_w_r)

__all__ = [
    "FaultModel", "sweep_models", "SITES", "KINDS", "TIMINGS",
    "CHECK_PATH_SITES", "CONSISTENT_SITES",
    "FaultInjector", "flip_bits",
    "CheckPathSelfCheck", "verify_w_r", "verify_s_c", "refold",
    "run_fault_campaign", "run_experiment", "ExperimentResult",
]
