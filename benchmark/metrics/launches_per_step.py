"""Device operations a step (kernels, memcpys, memsets) in the traced window:
the launches the host enqueues for the device, the eager step's dispatch
load."""


def read(t):
    return len(t.device_ops) / t.steps if t.device_ops else None
