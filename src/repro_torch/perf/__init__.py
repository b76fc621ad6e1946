"""Performance layer of the port: the measured tuner of the CUDA kernels'
launch shapes (:mod:`repro_torch.perf.tune`), the op-cost counter
(:mod:`repro_torch.perf.opcost`), the profiler views
(:mod:`repro_torch.perf.profile`) and the stage spans and counters
(:mod:`repro_torch.perf.spans`).

One-way, as the reference's ``repro.perf``: :mod:`repro_torch.kernels.ops`
and :mod:`repro_torch.core` import only :mod:`repro_torch.perf.spans`,
which imports nothing of the port.  The tuner measures through the
public ops and hands the winners to
:func:`repro_torch.kernels.ops.set_tuning`, so an untuned process
launches exactly as if the tuner did not exist.
"""
__all__ = ["tune", "opcost", "profile", "spans"]  # import the submodules explicitly
