"""A tiny cell for the CPU tests: the real configurations, a 32² traffic
of ``data/``, a BENCHMARK.json of its own."""

import json
import os
import shutil
import time

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))


def tiny_cell(tmp_path, traffic, config="jacobian", name=None, configs=()):
    """The harness's Cell of ``traffic`` (a file of ``data/traffic``)
    under ``config``; its own file is ``data/workloads/<traffic>.json``.
    ``configs`` are configurations (a file's contents, as
    :func:`config_copy` gives) written beside the real ones, under their
    names, for ``config`` to name."""
    name = name or traffic
    bench = harness.load(os.path.join(ROOT, "BENCHMARK.json"))
    bench["workloads"] = [{"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "portbench", "configs"),
                    root / "portbench" / "configs")
    for conf in configs:
        file = f"portbench/configs/{conf['name']}.json"
        (root / file).write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"],
                                 "source": conf["source"], "file": file,
                                 "reduced": [], "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.find_cell(name, root=str(root), pkg=DATA)


def config_copy(config, name, **changes):
    """The configuration file ``config`` of the benchmark as ``name``,
    with ``changes``."""
    conf = harness.load(os.path.join(ROOT, "portbench", "configs",
                                     config + ".json"))
    return {**conf, "name": name, **changes}


def run_tiny(tmp_path, cell, seed=2 ** 31 + 11, seconds=1.0, trace=False,
             **kw):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", work_dir=str(tmp_path / "work"),
                            **kw)
