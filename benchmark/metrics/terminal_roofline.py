"""terminal_roofline (%): the least time on an H100 SXM for the terminal
synthesis's work (the doubling DARE's steps and the gain,
``roofline.terminal_work``) over the device time a step under the
``terminal`` range."""
from benchmark import roofline
from benchmark.readers import roofline_share


def read(rec):
    if "nlift" not in rec:
        return None
    work = roofline.terminal_work(rec["batch"], rec["nlift"], rec["m"],
                                  rec["dare_iters"], rec["itemsize"])
    return roofline_share(rec, "terminal", work)
