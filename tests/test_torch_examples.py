"""The port's examples (``examples_torch/*.py``) run as a user runs them, as
subprocesses with ``--device cpu`` (the kernels' plain versions) at small
sizes, against the reference's ``examples/*.py`` where the reference
prints comparable numbers.  The processes that the selected tests of this
file read (``NEEDS``) start at once (one thread each), and only those;
each test reads its own.  The file wants one worker (the default
``--dist loadfile``): a worker that gets some of its tests starts what
they read.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
STREAM_ARGS = ["--channels", "4", "--samples", "4096"]
SERVE_LM_ARCHS = ["rwkv6-3b", "granite-3-8b"]
# the example runs each test reads
NEEDS = {
    "test_quickstart_matches_reference": ("quickstart", "quickstart_ref"),
    "test_stream_compress_matches_reference": ("stream", "stream_ref"),
    "test_serve_frontend_byte_identical": ("frontend",),
    "test_train_lm_restores_and_learns": ("train",),
    "test_serve_lm_tokens_in_vocab": tuple(f"serve_lm_{a}"
                                           for a in SERVE_LM_ARCHS),
}


def _commands(ckpt):
    """{name: (script, arguments)} of every example run."""
    cmds = {
        "quickstart": ("examples_torch/quickstart.py", ["--device", "cpu"]),
        "quickstart_ref": ("examples/quickstart.py", []),
        "stream": ("examples_torch/stream_compress.py",
                   STREAM_ARGS + ["--device", "cpu"]),
        "stream_ref": ("examples/stream_compress.py", STREAM_ARGS),
        "frontend": ("examples_torch/serve_frontend.py",
                     ["--device", "cpu", "--tenants", "2", "--samples",
                      "8192"]),
        "train": ("examples_torch/train_lm.py",
                  ["--device", "cpu", "--steps", "12", "--inject-crash",
                   "5", "--batch", "4", "--seq", "32", "--ckpt-dir", ckpt]),
    }
    for arch in SERVE_LM_ARCHS:
        cmds[f"serve_lm_{arch}"] = ("examples_torch/serve_lm.py",
                                    ["--device", "cpu", "--arch", arch,
                                     "--gen", "8"])
    return cmds


def _start(script, args=()):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, os.path.join(ROOT, script),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """{name: (returncode, stdout, stderr)} of the example runs that this
    file's selected tests read."""
    wanted = {n for item in request.session.items
              if item.module is request.module
              for n in NEEDS.get(item.originalname, ())}
    cmds = _commands(str(tmp_path_factory.mktemp("ckpt")))
    procs = {name: _start(*cmds[name]) for name in cmds if name in wanted}
    done = {}
    for name, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        done[name] = (proc.returncode, so, se[-3000:])
    return done


def _out(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, so[-2000:] + se
    return so


def test_quickstart_matches_reference(runs):
    """Ratios, peak, outlier and jump counts print as the reference's;
    the spectral errors agree within 1e-9 relative."""
    ours, ref = _out(runs, "quickstart"), _out(runs, "quickstart_ref")
    spectra = re.compile(r"spectra: (\{.*\})")
    strip = [spectra.sub("", ln) for ln in ours.splitlines()], \
        [spectra.sub("", ln) for ln in ref.splitlines()]
    assert strip[0] == strip[1]
    a = ast.literal_eval(spectra.search(ours).group(1))
    b = ast.literal_eval(spectra.search(ref).group(1))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-9), k


def test_stream_compress_matches_reference(runs):
    """The session's and the naive path's hit rates and ratios equal the
    reference's at the same channels and samples, and the chunked
    segments decode as the one-shot encode (the example exits 1 else)."""
    ours, ref = _out(runs, "stream"), _out(runs, "stream_ref")
    pat = re.compile(r"hit rate ([\d.]+%), ratio ([\d.]+)")
    assert pat.findall(ours) == pat.findall(ref)
    assert len(pat.findall(ours)) == 2
    assert "decode identically to one-shot encode" in ours


def test_serve_frontend_byte_identical(runs):
    """Each tenant's wire bytes equal its local shadow session's, and its
    range decode through the mux round-trips."""
    out = _out(runs, "frontend")
    same = re.findall(r"tenant-(\d+): .* local session: (\w+)", out)
    trips = re.findall(r"tenant-(\d+): range decode .*: (\w+)", out)
    assert sorted(same) == [("0", "True"), ("1", "True")]
    assert sorted(trips) == [("0", "True"), ("1", "True")]
    assert "throttled: finished after" in out
    assert "p99 POST /v1/feed" in out


def test_train_lm_restores_and_learns(runs):
    """The crash at step 5 is restored from a checkpoint and the loss
    falls (the example's own assertion, exit 1 else)."""
    out = _out(runs, "train")
    assert "'event': 'restore'" in out and "node failure at step 5" in out
    assert out.strip().endswith("OK")


@pytest.mark.parametrize("arch", SERVE_LM_ARCHS)
def test_serve_lm_tokens_in_vocab(arch, runs):
    out = _out(runs, f"serve_lm_{arch}")
    m = re.search(r"tokens \((\d+), (\d+)\) in \[0, (\d+)\): (\w+)", out)
    assert m and m.group(1, 2, 4) == ("4", "8", "True"), out
    vocab = int(m.group(3))
    for row in re.findall(r"request \d+: \[([\d, ]+)\]", out):
        toks = [int(t) for t in row.split(",")]
        assert len(toks) == 8 and all(0 <= t < vocab for t in toks)


def test_examples_import_neither_jax_nor_reference():
    """The five examples' imports load no ``jax`` and nothing of
    ``repro``."""
    code = (
        "import importlib.util, sys\n"
        "for name in ['quickstart', 'stream_compress', 'serve_frontend',\n"
        "             'serve_lm', 'train_lm']:\n"
        f"    path = {os.path.join(ROOT, 'examples_torch')!r} + '/' + name"
        " + '.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
