"""The port's KS cross-check (``python -m repro_torch.launch.ks_crosscheck``,
the counterpart of ``scripts/ks_crosscheck.py``) on the CPU: it passes with
the port's KS functions, and a p-value off by 1e-3 is reported as a
failure with exit code 1."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy")

from repro_torch.launch import ks_crosscheck  # noqa: E402


def test_crosscheck_passes_on_cpu(capsys):
    assert ks_crosscheck.main(["--device", "cpu", "--trials", "50"]) == 0
    out = capsys.readouterr().out
    assert "statistic random: 50 trials, 0 failures" in out
    assert "pvalue grid: 1089 points, 0 failures" in out
    assert out.strip().endswith("ks_crosscheck (cpu): PASS")


def test_doctored_pvalue_is_a_failure(monkeypatch, capsys):
    real = ks_crosscheck.ks_pvalue
    monkeypatch.setattr(ks_crosscheck, "ks_pvalue",
                        lambda d, n1, n2: real(d, n1, n2) - 1e-3)
    assert ks_crosscheck.main(["--device", "cpu", "--trials", "5"]) == 1
    out = capsys.readouterr().out
    assert "FAIL pvalue" in out and "FAIL identical" in out
    assert "ks_crosscheck (cpu): FAIL" in out


def test_crosscheck_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ks_crosscheck.main(["--trials", "1"])
