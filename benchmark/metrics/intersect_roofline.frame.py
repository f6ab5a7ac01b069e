"""The intersection kernels' share of their roofline (%): the least time of
the window's triangle casts (roofline.intersect_work, from rays and
triangles) ÷ the device time of K1, K6, K7, K8 and K9."""
from benchmark import roofline as R
from benchmark import trace as T


def read(tr):
    s = tr.kernel_s(T.INTERSECT_KERNELS)
    if s <= 0:
        return None
    if not tr.counters.casts:  # the kernels ran, the counters saw nothing
        raise RuntimeError("intersect_roofline.frame: kernels ran but no "
                           "triangle casts were counted "
                           "(trace.count_layers)")
    least = sum(R.least_s(*R.intersect_work(n, t, a))
                for n, t, a in tr.counters.casts)
    return 100.0 * least / s
