"""The device's idle share of a step: 1 - (the union of the device
operations' intervals a step, profiled) / (the step time of the same run's
unprofiled window), in percent. The profiler stretches the host's side of a
step, not the device's, so the busy time comes from the trace and the step
time from the window without it."""


def read(t):
    if not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.steps / t.step_s)
