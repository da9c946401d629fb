"""Per cent of the xc pass's bound that it reached: the bound of one pass
from its shape alone (harness/xc_count.py) over the device seconds per
``scf.xc`` span, in one more served job on the run's own state
(harness/served_spans.py)."""
from benchmark.harness import program_spans as ps
from benchmark.harness import served_spans as ss
from benchmark.harness.xc_count import xc_bound

NAME = "xc_roofline.kuks_pbeu"


def probe(ctx):
    return ss.served_job(ctx)


def read(run):
    d = ps.probed(run, NAME)
    if not d or "scf.xc" not in d["spans"] or not d["job"]["xc_shape"] \
            or d["job"]["complex"] is None:
        return None
    row = d["spans"]["scf.xc"]
    if not row["n"] or row["device_s"] <= 0:
        return None
    bound = xc_bound(*d["job"]["xc_shape"], dname=d["job"]["complex"])[2]
    return 100.0 * bound * row["n"] / row["device_s"]
