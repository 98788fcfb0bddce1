"""The benchmark is insulated from the JAX side: a process that imports
every module of ``bench/`` (and the port it drives) holds no top-level
``jax``, ``jaxlib``, ``flax`` or ``repro`` module, and the plain
reference loads nothing of the port, nor torch."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_EVERY_MODULE = r"""
import importlib, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
import bench.run
from bench.harness import core, env, devtrace, kwork, signals, ingest, reads
for p in sorted((root / "bench" / "metrics").glob("*.py")):
    core.load_metric(root / "bench", p.stem)
bench = core.Bench(root / "bench")
for c in bench.spec["configs"]:
    env.load_reference(bench, bench.config(c["name"]))
import repro_torch.serve, repro_torch.store, repro_torch.core.session
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE_ONLY = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("ref", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_names(code, arg):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(arg)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_bench_process_holds_no_jax_or_jax_package():
    names = _top_names(_EVERY_MODULE, ROOT)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    names = _top_names(_REFERENCE_ONLY,
                       ROOT / "bench" / "reference" / "idealem_np.py")
    assert "numpy" in names
    assert not names & {"repro_torch", "repro", "torch", "jax"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    """``repro_torch`` begins with ``repro`` and is no JAX package."""
    import types
    sys.path.insert(0, str(ROOT))
    from bench.harness.core import forbidden_modules
    for name in ("jaxlib.fake_part", "repro.fake_part", "repro_torch_fake",
                 "jaxtyping_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    bad = set(forbidden_modules())
    assert {"jaxlib.fake_part", "repro.fake_part"} <= bad
    assert not bad & {"repro_torch_fake", "jaxtyping_fake"}
