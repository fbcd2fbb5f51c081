"""Import guard and device policy of the PyTorch port.

No file of ``src/repro_torch`` (nor ``chip_smoke.py`` and the
``examples/*_torch.py`` entry points) imports ``jax``, anything of the
reference package ``repro`` or the reference's ``benchmarks`` scripts;
importing every port module in a fresh interpreter leaves ``jax`` out of
``sys.modules``; entry points raise instead of falling back to the CPU
when no GPU is present.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _imported(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for name in _imported(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "benchmarks"), \
            (path, name)


def test_fresh_interpreter_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
            "                                    'benchmarks'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import LMBackend, main
    from repro_torch.models.context import RunContext
    cfg = reduced_config(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMBackend(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RunContext.on()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--handler", "--requests", "1"])
    assert RunContext.on("cpu").impl == "torch"


def test_cli_serves_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--handler", "--requests", "3", "--new-tokens", "3",
          "--device", "cpu", "--window", "2"])
    assert "served=3" in capsys.readouterr().out
