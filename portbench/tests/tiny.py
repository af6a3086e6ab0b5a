"""Configurations of the benchmark cut to a coarser spacing: the same file
with the spacing, time step, box and particle count of the registered case
at that spacing. The CPU tests run them at a few hundred particles."""
from __future__ import annotations

import copy

from portbench import bench

#: Spacings at which the cases hold about a thousand particles.
TINY_DS = {"taylor_green": 1.0 / 32, "dam_break": 0.05}


def config(name: str, ds: float | None = None, **case_args) -> dict:
    """``configs/<name>.json`` at ``ds`` (default: its case's tiny
    spacing), with ``case_args`` over the file's."""
    from repro_torch.core import cases

    conf = copy.deepcopy(bench.load("configs", name))
    ds = ds or TINY_DS[conf["case"]]
    conf["case_args"].update(case_args)
    case = cases.build_case(conf["case"], ds=ds, **conf["case_args"])
    dom = case.domain()
    conf["ds"] = ds
    conf["physics"]["dt"] = case.dt
    conf["box"]["lo"], conf["box"]["hi"] = list(dom.lo), list(dom.hi)
    conf["n_particles"] = bench.make_inputs(conf, 0, "cpu")["x"].shape[0]
    return conf
