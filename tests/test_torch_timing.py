"""The port's two kernel times, on the CPU: a run record's ``ms`` (a call
as a caller waits for it, host issue included) and ``device_ms`` (the
card's time of a call), how manifests keep them and how the readers print
them, and the device timer's check that the card never waited for the
host (:func:`repro_torch.kernels.held_call_ms`)."""

import json

import pytest

from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.core import render, session
from repro_torch.kernels import gemm

CARD = "NVIDIA H100 80GB HBM3"
RUN = {"device": CARD, "launches": 43, "ms": 0.0364, "device_ms": 0.0047,
       "max_abs_err": 0.0, "dtype": "float32", "shapes": [[64, 64], [64, 64]]}


def _write(path, run):
    pk = session.profile_kernel(gemm.gemm_v00_spec(64, 64, 64), name="gemm",
                                variant="v00", run=run)
    session.write_iteration(path, [pk])
    return pk


@pytest.mark.parametrize("ref", ["gemm:v01", "histogram:naive", "gramschm:opt", "ttm:fused"])
def test_a_cpu_run_records_neither_time(ref):
    run = kreg.run_variant(kreg.resolve(ref)[1], device="cpu")
    assert run["device"] == "cpu" and run["launches"] == 0
    assert run["ms"] is None and run["device_ms"] is None


def test_cli_profile_on_the_cpu_writes_device_ms_none(tmp_path, capsys):
    out = tmp_path / "s"
    assert cli.main(["profile", "-k", "ttm:fused", "--device", "cpu", "--out", str(out)]) == 0
    assert "ran the plain version on cpu (no kernel launched, not timed)" in capsys.readouterr().out
    (entry,) = json.loads((out / "iter0" / "manifest.json").read_text())["kernels"]
    assert entry["run"]["ms"] is None and entry["run"]["device_ms"] is None


def test_a_manifest_round_trips_both_times(tmp_path):
    _write(tmp_path / "it", RUN)
    back = session.load_iteration(tmp_path / "it").kernels[0]
    assert back.run == RUN


def test_a_manifest_without_device_ms_loads_and_renders_it_not_measured(tmp_path):
    old = {k: v for k, v in RUN.items() if k != "device_ms"}
    _write(tmp_path / "it", old)
    back = session.load_iteration(tmp_path / "it").kernels[0]
    assert back.run == old
    want = f"launched 43x on {CARD}: time on the card not measured (0.0364 ms with host issue)"
    assert render.run_text(back.run).startswith(want)
    assert cli.main(["report", str(tmp_path / "it")]) == 0
    report = tmp_path / "it" / "report"
    assert want in (report / "report.md").read_text()
    assert want in (report / "index.html").read_text()


def test_run_text_prints_the_cards_time_first_then_the_time_with_host_issue():
    text = render.run_text(RUN)
    assert text == (f"launched 43x on {CARD}: 0.0047 ms a call on the card (0.0364 ms "
                    "with host issue), max |err| vs plain 0.00e+00")
    assert render.run_text(dict(RUN, shared_with="l0")).endswith(
        " (shared with l0: same kernel, same shapes)")


def test_held_call_ms_is_the_spans_mean_when_the_sleep_outlasted_the_issue():
    assert kreg.held_call_ms(0.117, 20, sleeping=True) == pytest.approx(0.00585)


def test_held_call_ms_raises_where_the_sleep_ended_before_the_last_call_was_issued():
    with pytest.raises(kreg.QueueDrained, match="all 20 calls"):
        kreg.held_call_ms(0.8, 20, sleeping=False)


@pytest.mark.parametrize("span_ms, iters", [(0.0, 20), (-1.0, 20), (1.0, 0)])
def test_held_call_ms_refuses_a_record_it_cannot_read(span_ms, iters):
    with pytest.raises(ValueError):
        kreg.held_call_ms(span_ms, iters, sleeping=True)


def test_device_time_ms_times_once_more_behind_a_longer_sleep_and_then_raises(monkeypatch):
    """The retry sleeps twice as long, and at least four times the host's
    issue of the drained batch; a second drained batch raises, never
    returning a span in which the card may have waited for the host."""
    sleeps = []

    def held_calls(records):
        def fake(fn, iters, sleep_ms):
            sleeps.append(sleep_ms)
            span_ms, sleeping = records.pop(0)
            return span_ms, sleeping, 7.0
        return fake

    good, drained = (0.01, True), (0.6, False)
    monkeypatch.setattr(kreg, "_held_calls", held_calls([drained, good]))
    assert kreg.device_time_ms(lambda: None, iters=5, warmup=0) == pytest.approx(0.002)
    assert sleeps == [kreg.SLEEP_MIN_MS, max(2 * kreg.SLEEP_MIN_MS, 28.0)]
    monkeypatch.setattr(kreg, "_held_calls", held_calls([drained, drained]))
    with pytest.raises(kreg.QueueDrained):
        kreg.device_time_ms(lambda: None, iters=5, warmup=0)
