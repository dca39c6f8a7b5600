"""Device ms a DaeMon training step spends after its gradients: the kernels
launched under the port's ranges ``daemon_step.fold``, ``.adamw`` and
``.working_copy``, per traced step.  K1 and K2 run there and nowhere else in
the step; the profiler records their kernels but not their launches (their
library links the CUDA runtime statically), so their time is added by name."""
from bench.harness.kernels import names

RANGES = ("daemon_step.fold", "daemon_step.adamw", "daemon_step.working_copy")


def read(t):
    if t.traffic["kind"] != "train" or not t.units or not any(r in t.op_ms for r in RANGES):
        return None
    ms = sum(t.op_ms.get(r, 0.0) for r in RANGES) + t.unattributed_ms(names("bq"))
    return ms / len(t.units)
