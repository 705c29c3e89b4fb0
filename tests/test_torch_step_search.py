"""The initial step-size search (``sampler/run.py:find_initial_step``) on
the CPU, float64, on ``logp(x) = -sum(x^4) / 4 - sum(x^2) / 2`` in two
dimensions, whose curvature grows with ``|x|``: chains started at
different distances stop their search at different iterations.

- Each chain of a fleet gets the bits it gets searched alone.
- The search equals the JAX package's ``find_initial_step`` under
  ``jax.vmap`` on the same fleet (rtol 1e-12).
- A chain whose search has ended probes its start: after a chain's own
  calls, the log density sees its start position in that row on every
  later call (a chain in a costly region, an ODE solve at its step cap,
  no longer holds the fleet there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.model import make_model as jmake_model
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.nuts import init_machine_state as jinit_machine_state
from nutpie_tpu.sampler.run import find_initial_step as jfind_initial_step
from nutpie_tpu_torch.model import make_model
from nutpie_tpu_torch.sampler.adapt import AdaptConfig
from nutpie_tpu_torch.sampler.nuts import NutsConfig, init_machine_state
from nutpie_tpu_torch.sampler.run import chain_keys, find_initial_step

torch.set_num_threads(1)

STARTS = np.array([[6.0, -5.0], [0.05, 0.1], [1.0, 2.0], [-3.0, 0.5], [0.3, -0.2]])


def _logp(x):
    return -0.25 * torch.sum(x ** 4, 1) - 0.5 * torch.sum(x ** 2, 1)


def _jlogp(x):
    return -0.25 * jnp.sum(x ** 4) - 0.5 * jnp.sum(x ** 2)


def _state(rows, log_step=0.0):
    model = make_model(2, _logp)
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=100))
    pos = torch.as_tensor(STARTS[rows])
    logp, grad = model.logp_and_grad(pos)
    keys = chain_keys(3, len(STARTS), "cpu")[rows]
    state = init_machine_state(cfg, keys, pos, grad, logp, torch.float64)
    return cfg, state


def _search(rows, calls=None):
    cfg, state = _state(rows)
    model = make_model(2, _logp)

    def logp_and_grad(x):
        if calls is not None:
            calls.append(x.clone())
        return model.logp_and_grad(x)

    return find_initial_step(cfg, logp_and_grad, state).adapt_flt("log_step"), state


def test_fleet_equals_chains_alone():
    fleet, _ = _search(list(range(len(STARTS))))
    alone = torch.stack([_search([c])[0][0] for c in range(len(STARTS))])
    assert torch.equal(fleet, alone)
    assert len(set(fleet.tolist())) > 2  # the chains part


def test_matches_jax():
    rows = list(range(len(STARTS)))
    fleet, state = _search(rows)
    jcfg = JNutsConfig(adapt=JAdaptConfig(num_tune=100))
    jmodel = jmake_model(2, _jlogp)
    pos = jnp.asarray(STARTS)
    logp, grad = jax.vmap(jax.value_and_grad(jmodel.logp_fn))(pos)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(jnp.arange(len(STARTS)))
    js = jax.vmap(lambda k, p, g, lp: jinit_machine_state(jcfg, k, p, g, lp, jnp.float64))(
        keys, pos, grad, logp)
    jout = jax.vmap(lambda s: jfind_initial_step(jcfg, jax.value_and_grad(jmodel.logp_fn),
                                                 s))(js)
    np.testing.assert_allclose(fleet.numpy(), np.asarray(jout.adapt.da.log_step), rtol=1e-12)


@pytest.mark.parametrize("chain", range(len(STARTS)))
def test_an_ended_search_probes_its_start(chain):
    own: list = []
    _search([chain], own)
    calls: list = []
    _search(list(range(len(STARTS))), calls)
    later = [x[chain] for x in calls[len(own):]]
    start = torch.as_tensor(STARTS[chain])
    assert all(torch.equal(x, start) for x in later)
    # while its search runs, the chain's own probes are what it sees alone
    for x_fleet, x_own in zip(calls[:len(own)], own):
        assert torch.equal(x_fleet[chain], x_own[0])
