"""Background sampling control of the port against the JAX package.

The cases of ``tests/test_control.py`` on ``nutpie_tpu_torch`` (a
non-blocking ``wait``, a ``wait`` timeout, pause/resume/abort, ``inspect``
of a partial run, the progress callback's last snapshot, callback errors
swallowed), then: a blocking and a non-blocking run of one seed give the
same trace bitwise; the progress snapshots of both packages for one run
agree (chain count, finished and total draws and the tuning flag in every
call, divergences and gradient counts in the first chunk's call, where no
warmup has yet amplified rounding); ``render_template`` renders the same
string in both.  CPU, float64; every loop that waits on the sampling
thread has a deadline.
"""

import time

import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.progress import ChainProgress as JChainProgress
from nutpie_tpu.progress import render_template as jrender_template
from nutpie_tpu_torch import ChainProgress
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.progress import DEFAULT_HTML_TEMPLATE, render_template

torch.set_num_threads(1)

DEADLINE_S = 60


def _model():
    return compile_model_def(tm.std_normal(2))


def _sample(**kwargs):
    return nutpie_tpu_torch.sample(_model(), device="cpu", progress_bar=False, **kwargs)


def _until(cond, what: str):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_nonblocking_wait():
    sampler = _sample(chains=2, draws=60, tune=40, seed=1, blocking=False)
    trace = sampler.wait(timeout=DEADLINE_S)
    assert sampler.is_finished
    assert np.asarray(trace.posterior["x"].values).shape == (2, 60, 2)


def test_wait_timeout():
    sampler = _sample(chains=2, draws=50_000, tune=1000, seed=1, blocking=False,
                      chunk_size=16)
    with pytest.raises(TimeoutError):
        sampler.wait(timeout=0.05)
    sampler.cancel()
    assert sampler.is_finished


def test_pause_resume_abort():
    sampler = _sample(chains=2, draws=100_000, tune=50, seed=2, blocking=False,
                      chunk_size=16)
    _until(lambda: sampler._draws_done >= 16, "a chunk")
    sampler.pause()
    time.sleep(0.3)  # the chunk in flight may still land
    paused_at = sampler._draws_done
    time.sleep(0.3)
    assert sampler._draws_done == paused_at, "the loop ran on while paused"
    sampler.resume()
    _until(lambda: sampler._draws_done > paused_at, "the resumed loop")
    trace = sampler.abort()
    assert sampler.is_finished
    x = np.asarray(trace.posterior["x"].values)
    assert 0 < x.shape[1] < 100_000 and np.isfinite(x).all()


def test_inspect_partial():
    sampler = _sample(chains=2, draws=100_000, tune=16, seed=3, blocking=False,
                      chunk_size=16)
    _until(lambda: sampler._draws_done >= 48, "posterior draws")
    trace = sampler.inspect()
    n1 = np.asarray(trace.posterior["x"].values).shape[1]
    assert n1 >= 32
    sampler.cancel()


def test_progress_callback():
    calls = []

    def cb(progress):
        calls.append([(p.chain_index, p.finished_draws, p.total_draws, p.tuning)
                      for p in progress])

    _sample(chains=3, draws=50, tune=50, seed=4, progress_callback=cb, progress_rate=0,
            chunk_size=25)
    assert calls
    final = calls[-1]
    assert len(final) == 3
    assert all(fd == 100 and td == 100 and not tuning for _, fd, td, tuning in final)


def test_callback_errors_swallowed(capsys):
    def bad_cb(progress):
        raise RuntimeError("boom")

    trace = _sample(chains=2, draws=30, tune=30, seed=5, progress_callback=bad_cb,
                    progress_rate=0)
    assert np.asarray(trace.posterior["x"].values).shape == (2, 30, 2)
    assert "boom" in capsys.readouterr().err


def test_blocking_and_nonblocking_runs_are_bitwise_equal():
    common = dict(chains=2, draws=40, tune=40, seed=6, chunk_size=16,
                  return_raw_trace=True)
    blocking = _sample(**common)
    background = _sample(blocking=False, **common).wait(timeout=DEADLINE_S)
    np.testing.assert_array_equal(background["position"], blocking["position"])
    for group in ("stats", "expanded"):
        assert background[group].keys() == blocking[group].keys()
        for name, ref in blocking[group].items():
            np.testing.assert_array_equal(background[group][name], ref, err_msg=name)


def test_progress_snapshots_match_jax():
    """Both packages run eight schools (4 chains, 32 + 32 draws in 16-draw
    chunks) with a callback on every chunk."""
    def recorder(calls):
        return lambda progress: calls.append(
            [(p.chain_index, p.finished_draws, p.total_draws, p.tuning,
              p.divergences, p.total_num_steps) for p in progress])

    common = dict(chains=4, draws=32, tune=32, seed=8, chunk_size=16,
                  progress_bar=False, progress_rate=0)
    ours, ref = [], []
    nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu",
                            progress_callback=recorder(ours), **common)
    nutpie_tpu.sample(jax_compile(jm.eight_schools()), progress_callback=recorder(ref),
                      **common)
    assert len(ours) == len(ref) >= 4
    for got, want in zip(ours, ref):
        assert len(got) == len(want) == 4
        assert [g[:4] for g in got] == [w[:4] for w in want]
    assert ours[0] == ref[0]


def test_render_template_matches_jax():
    fields = [dict(chain_index=c, finished_draws=10 * c, total_draws=40,
                   divergences=c % 2, tuning=c < 2, started=True, finished=c == 4,
                   latest_num_steps=3 + c, total_num_steps=100 * c,
                   step_size=0.1234567 * (c + 1), runtime_ms=1500.0 + c,
                   divergent_draws=[c] * (c % 2))
              for c in range(5)]
    ours = [ChainProgress(**f) for f in fields]
    ref = [JChainProgress(**f) for f in fields]
    custom = ("{{ finished_draws }}/{{ total_draws }} ~{{ time_remaining_estimate }} "
              "{% for chain in chains %}[{{ chain.chain_index }} {{ chain.phase }} "
              "{{ chain.step_size }} {{ chain.row_class }}]{% endfor %}")
    for template in (DEFAULT_HTML_TEMPLATE, custom):
        assert render_template(template, ours) == jrender_template(template, ref)
