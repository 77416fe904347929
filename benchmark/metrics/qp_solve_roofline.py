"""qp_solve_roofline (%): the least time on an H100 SXM for the box QP's
work (the KKT inverse at nx = N m and the ADMM iterations,
``roofline.qp_solve_work``) over the device time a step under the
``qp_solve`` range."""
from benchmark import roofline
from benchmark.readers import roofline_share


def read(rec):
    if "nx" not in rec:
        return None
    work = roofline.qp_solve_work(rec["batch"], rec["nx"], rec["qp_iters"],
                                  rec["itemsize"])
    return roofline_share(rec, "qp_solve", work)
