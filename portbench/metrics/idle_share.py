"""idle_share: the share of the profiled stretch in which no operation ran
on the device, in percent: its busy time from torch.profiler's device
records, a kernel whose records fell short of its launches timed by CUDA
events in their place (``trace.with_event_times``)."""


def read(ctx):
    st = ctx.stretch
    if st is None or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
