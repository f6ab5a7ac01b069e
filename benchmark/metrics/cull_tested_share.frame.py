"""% of the box tests asked of K8 (csrc/epoch_cull.cu) that it ran in the
traced window: the program's card counter `cull_tests`
(raytrace_tpu_torch/utils/metrics.py `DEVICE_COUNTERS`, which K8 adds to
while a profiler records, over the card-only frames and the host-traced
one): the tests its live warps ran on the scene box, the group hulls and
the real clusters ÷ live warps × real clusters. Read after the window.
None for a program without the counter or a window without a K8 launch."""


def read(tr):
    from raytrace_tpu_torch.utils import metrics

    counters = getattr(metrics, "DEVICE_COUNTERS", None)
    if not counters:
        return None
    ran = asked = 0
    for (name, _), buf in counters.items():
        if name == "cull_tests":
            r, a = buf.tolist()
            ran, asked = ran + r, asked + a
    return 100.0 * ran / asked if asked else None
