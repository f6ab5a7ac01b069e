"""The gather kernels' share of their roofline (%): the least time of the
window's gathers (roofline.gather_work, from slots, queries and the pairs
inside the radius, which the gathers' counts sum to) ÷ their device time."""
from benchmark import roofline as R
from benchmark import trace as T


def read(tr):
    s = tr.kernel_s(T.GATHER_KERNELS)
    if s <= 0:
        return None
    if not tr.counters.gathers:  # the kernels ran, the counters saw nothing
        raise RuntimeError("gather_roofline.frame: kernels ran but no gathers "
                           "were counted (trace.count_layers)")
    least = sum(R.least_s(*R.gather_work(p, q, int(m.sum())))
                for p, q, m in tr.counters.gathers)
    return 100.0 * least / s
