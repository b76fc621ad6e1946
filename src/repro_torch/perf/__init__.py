"""Performance layer of the port: the measured tuner of the CUDA kernels'
launch shapes (:mod:`repro_torch.perf.tune`), the op-cost counter
(:mod:`repro_torch.perf.opcost`) and the profiler views
(:mod:`repro_torch.perf.profile`).

One-way, as the reference's ``repro.perf``: :mod:`repro_torch.kernels.ops`
never imports it.  The tuner measures through the public ops and hands
the winners to :func:`repro_torch.kernels.ops.set_tuning`, so an untuned
process launches exactly as if this package did not exist.
"""
__all__ = ["tune", "opcost", "profile"]  # import the submodules explicitly
