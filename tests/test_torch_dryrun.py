"""The dry-run's accounting on the CPU: one subprocess joins a fake process
group of 4 ranks (``torch.testing``'s ``FakeStore``), traces small known
programs and reduced-depth steps on fake tensors, the recurrent
architectures' train steps on fake groups of 4 and of 1, then one
full-size cell on a fake group of 256, and returns its numbers as JSON
(run once per session, shared across xdist workers)."""
from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(HERE), "..", "src")
SPLIT_ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "n_devices",
            "n_params", "n_active_params", "lower_seconds",
            "compile_seconds", "memory", "fits_hbm", "cost_reported",
            "collectives_reported", "corrected"}


def _main(out: str) -> None:
    import dataclasses
    import logging

    import torch
    sys.path.insert(0, SRC)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo_analysis as H, steps

    res = {}
    mesh = dryrun.fake_world(4)                  # (data 1, model 4)
    fc = torch.ops._c10d_functional
    group = mesh.get_group(1).group_name
    with FakeTensorMode():
        x = torch.empty(4, 8)
        progs = {
            "all-gather": lambda: fc.all_gather_into_tensor(x, 4, group),
            "reduce-scatter": lambda: fc.reduce_scatter_tensor(
                torch.empty(8, 8), "sum", 4, group),
            "all-reduce": lambda: fc.all_reduce(x, "sum", group),
            "all-to-all": lambda: fc.all_to_all_single(x, [1] * 4, [1] * 4,
                                                       group),
        }
        res["coll"] = {k: H.collective_bytes(H.trace(f)[1])
                       for k, f in progs.items()}

        a = torch.empty(8, 16)
        w = torch.empty(16, 32)
        rep = (Replicate(), Replicate())
        ad = DTensor.from_local(a, mesh, rep, run_check=False)
        wsh = DTensor.from_local(torch.empty(16, 8), mesh,
                                 (Replicate(), Shard(1)), run_check=False)
        wrep = DTensor.from_local(w, mesh, rep, run_check=False)
        res["flops_sharded"] = H.cost_metrics(
            H.trace(lambda p, q: p @ q, ad, wsh)[1])["flops"]
        res["flops_replicated"] = H.cost_metrics(
            H.trace(lambda p, q: p @ q, ad, wrep)[1])["flops"]
        res["matmul_memory"] = H.memory_metrics(
            H.trace(lambda p, q: p @ q, a, w)[1])

    cfg = dataclasses.replace(
        configs.reduced_config(configs.get_config("smollm-360m")),
        n_layers=4)
    shape = ShapeConfig("tiny", "train", 32, 8)
    ctx = steps.make_context(mesh=mesh)
    full = dryrun.lower_cell(cfg, shape, mesh, ctx)[0]
    c = {k: dryrun.lower_cell(dryrun._analysis_cfg(cfg, k), shape, mesh,
                              ctx)[0] for k in (1, 2)}
    res["depth"] = {}
    for key, get in (("flops", lambda r: r.flops),
                     ("bytes_accessed", lambda r: r.bytes_accessed),
                     ("collective_bytes",
                      lambda r: H.collective_bytes(r)["total"])):
        res["depth"][key] = [get(full),
                             get(c[1]) + 3 * (get(c[2]) - get(c[1]))]
    res["depth_memory"] = H.memory_metrics(full)

    # the recurrent blocks' train steps, per device, on (1, 4) and (1, 1)
    res["split_flops"] = {}
    short = ShapeConfig("short", "train", 8, 4)
    for world in (4, 1):
        mesh_w = dryrun.fake_world(world)
        for arch in SPLIT_ARCHS:
            rc = configs.reduced_config(configs.get_config(arch))
            rec = dryrun.lower_cell(rc, short, mesh_w,
                                    steps.make_context(mesh=mesh_w))[0]
            res["split_flops"].setdefault(arch, {})[world] = rec.flops

    outdir = os.path.join(os.path.dirname(out), "records")
    try:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--no-analysis", "--out", outdir])
    except SystemExit as e:
        res["cli_exit"] = e.code
    with open(os.path.join(outdir,
                           "smollm-360m__decode_32k__16x16.json")) as f:
        res["record"] = json.load(f)
    with open(out, "w") as f:
        json.dump(res, f)


def _run(tmp) -> dict:
    out = os.path.join(tmp, "dryrun.json")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, HERE, out], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def dry(tmp_path_factory):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _run(str(tmp_path_factory.mktemp("dry")))
    root = tmp_path_factory.getbasetemp().parent
    path = root / "torch_dryrun.json"
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.is_file():
            return json.loads(path.read_text())
        tmp = root / "torch_dryrun"
        tmp.mkdir(exist_ok=True)
        data = _run(str(tmp))
        path.write_text(json.dumps(data))
        return data


@pytest.mark.parametrize("kind,want", [("all-gather", 128),
                                       ("reduce-scatter", 256),
                                       ("all-reduce", 128),
                                       ("all-to-all", 128)])
def test_collective_bytes_semantics(dry, kind, want):
    """Operand bytes per device: an all-gather of a (4, 8) float32 over 4
    ranks counts its 128 local bytes, a reduce-scatter its full input."""
    got = dry["coll"][kind]
    assert got[kind] == want and got["total"] == want, got


def test_flops_are_counted_per_device(dry):
    """A matmul whose weight is split over 4 model ranks counts a quarter
    of its FLOPs on rank 0; a replicated one counts them all."""
    assert dry["flops_replicated"] == 2 * 8 * 16 * 32
    assert dry["flops_sharded"] == 2 * 8 * 16 * 32 / 4


@pytest.mark.parametrize("key", ["flops", "bytes_accessed",
                                 "collective_bytes"])
def test_depth_correction_equals_full_depth(dry, key):
    """Reduced smollm-360m at 4 layers on a (1, 4) mesh: the reference's
    k = 1 / k = 2 extrapolation equals the full-depth count exactly."""
    full, corrected = dry["depth"][key]
    assert full > 0 and corrected == full


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_recurrent_blocks_split_over_the_model_axis(dry, arch):
    """A reduced train step traced on a fake (1, 4) mesh counts at most
    0.4x the per-device FLOPs of the same step on one device: RWKV-6's
    heads and d_ff, RG-LRU's channels (and the rest of the model) are
    split, not computed whole on every model rank."""
    f = dry["split_flops"][arch]
    assert 0 < f["4"] <= 0.4 * f["1"], f


def test_memory_accounting(dry):
    m = dry["matmul_memory"]
    assert m["argument_bytes"] == (8 * 16 + 16 * 32) * 4
    assert m["output_bytes"] == 8 * 32 * 4
    assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"]
    d = dry["depth_memory"]
    assert d["peak_bytes"] >= d["argument_bytes"] > 0
    assert d["alias_bytes"] > 0          # AdamW's moments, in place


def test_full_size_cell_record_has_reference_keys(dry):
    rec = dry["record"]
    assert dry.get("cli_exit", 0) == 0
    assert set(rec) == REF_KEYS, set(rec) ^ REF_KEYS
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes"}
    assert set(rec["cost_reported"]) == {"flops", "bytes_accessed"}
    assert set(rec["collectives_reported"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    assert rec["fits_hbm"] and rec["cost_reported"]["flops"] > 0


if __name__ == "__main__":
    _main(sys.argv[1])
