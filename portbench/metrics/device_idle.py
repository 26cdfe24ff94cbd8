"""``device_idle``: the share of the profiled span in which no operation
ran on the device (``torch.profiler``'s CUDA timeline), %."""


def read(out: dict):
    d = out.get("device_trace")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
