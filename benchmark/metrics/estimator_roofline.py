"""estimator_roofline (%): the least time on an H100 SXM for the Woodbury
estimator's work (``estimator_work.woodbury_work`` at the polish and the
outputs of ``configs/duffing_rbf128.json``) over the device time a step
under the ``estimator`` range of a sweep's stretch; None where the run's
lifted width is not that configuration's."""
from benchmark import estimator_work, spec
from benchmark.readers import roofline_share


def read(rec):
    if "nlift" not in rec:
        return None
    work = estimator_work.config_work(
        rec, spec.part(spec.ROOT, "configs", "duffing_rbf128"))
    return None if work is None else roofline_share(rec, "estimator", work)
