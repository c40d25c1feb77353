"""The tick simulator's kernel (``csrc/jaxsim.cu``: ``jaxsim_kernel``):
its device time (profiler) over the lanes the window ran, in us."""

JAXSIM_KERNEL = "jaxsim_kernel"


def read(run):
    dt = getattr(run, "device_trace", None)
    ks = None if dt is None else dt.kernel_seconds(JAXSIM_KERNEL)
    if not ks or not run.lanes:
        return None
    return 1e6 * ks / run.lanes
