"""The port's Stan math library against the JAX package's, name by name.

Every entry of ``DISTRIBUTIONS``, ``LCDFS``, ``LCCDFS`` and ``FUNCTIONS``
is evaluated in both packages at seeded arguments (float64, CPU), one
parametrized case per name: closed forms to rtol 1e-12, the series
(``betainc``, ``gammainc``/``gammaincc``, ``owens_t`` and what is built on
them) to rtol 1e-9, each relative to the output's largest magnitude (at
least 1).  Gradients with respect to every real argument JAX
differentiates are held too: closed forms to 1e-10, series to 1e-7 (the
port takes d/da of the incomplete gamma function by a fourth-order
difference, ``xp._gammainc_da``).  Where the JAX library has a known
fault (ROADMAP queue 3), the arguments stay where it is right; the
faults themselves are held against scipy in ``test_torch_stan_faults.py``.
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.frontends.stan import stanlib as J
from nutpie_tpu_torch.frontends.stan import stanlib as T
from nutpie_tpu_torch.frontends.stan import xp

torch.set_num_threads(1)

_RNG = np.random.default_rng(2026)


def _spd(n=3, seed=0):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def _corr_chol(n=3, seed=1):
    s = _spd(n, seed)
    d = np.sqrt(np.diag(s))
    return np.linalg.cholesky(s / np.outer(d, d))


def _simplex(n=3, seed=2):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    return w / w.sum()


def _transition(k=3, seed=3):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, (k, k))
    return w / w.sum(axis=1, keepdims=True)


# argument makers: a float array, a float scalar, or an int (array or scalar)
ARGS = {
    "r": lambda: _RNG.normal(size=3),
    "R": lambda: float(_RNG.normal()),
    "p": lambda: _RNG.uniform(0.5, 3.0, 3),
    "P": lambda: float(_RNG.uniform(0.5, 3.0)),
    "g": lambda: _RNG.uniform(1.5, 4.0, 3),      # above 1 (acosh, shapes)
    "u": lambda: _RNG.uniform(0.1, 0.9, 3),
    "U": lambda: float(_RNG.uniform(0.1, 0.9)),
    "h": lambda: float(_RNG.uniform(0.1, 0.45)),   # a skewness below 1/2
    "k": lambda: np.array([0, 2, 5], np.int64),
    "K": lambda: 3,
    "n": lambda: np.array([8, 9, 12], np.int64),
    "N": lambda: 10,
    "c": lambda: 2,
    "C3": lambda: np.array([1, 3, 2], np.int64),
    "b": lambda: np.array([0, 1, 1], np.int64),
    "s": lambda: _simplex(),
    "S": lambda: _spd(),
    "S2": lambda: _spd(seed=5),
    "L": lambda: np.linalg.cholesky(_spd()),
    "LC": lambda: _corr_chol(),
    "Q": lambda: _corr_chol() @ _corr_chol().T,
    "M": lambda: _RNG.normal(size=(3, 3)),
    "X": lambda: _RNG.normal(size=(4, 3)),
    "rv": lambda: _RNG.normal(size=(1, 3)),
    "o": lambda: np.array([-0.7, 0.4]),
    "y4": lambda: np.array([0, 1, 3, 2], np.int64),
    "c4": lambda: np.array([1, 3, 2, 3], np.int64),
    "m3": lambda: np.array([2, 0, 3], np.int64),
    "lo": lambda: _RNG.normal(size=(3, 5)),
    "G": lambda: _transition(),
    "v6": lambda: _RNG.normal(size=6),
    "pos": lambda: float(_RNG.uniform(0.2, 0.8)),
    "neg": lambda: float(-_RNG.uniform(0.2, 3.0)),
    "2": lambda: 2,
    "3": lambda: 3,
    "1": lambda: 1,
    "W": lambda: _spd(seed=7),
    "t": lambda: _RNG.uniform(0.6, 2.0, 3),      # wiener times past tau
    "tau": lambda: 0.3,
    "yb": lambda: np.array([2, 4, 7], np.int64),  # beta-binomial counts
}

SERIES = {"series"}

# (argument kinds, tolerance class) per name; "closed" or "series"
DISTS = {
    "normal": ("r R P", "closed"), "std_normal": ("r", "closed"),
    "lognormal": ("p R P", "closed"), "student_t": ("r P R P", "closed"),
    "cauchy": ("r R P", "closed"), "double_exponential": ("r R P", "closed"),
    "logistic": ("r R P", "closed"), "gumbel": ("r R P", "closed"),
    "exponential": ("p P", "closed"), "gamma": ("p P P", "closed"),
    "inv_gamma": ("p P P", "closed"), "chi_square": ("p P", "closed"),
    "beta": ("u P P", "closed"), "uniform": ("u neg P", "closed"),
    "weibull": ("p P P", "closed"), "pareto": ("g pos P", "closed"),
    "bernoulli": ("b U", "closed"), "bernoulli_logit": ("b R", "closed"),
    "binomial": ("k N U", "closed"), "binomial_logit": ("k N R", "closed"),
    "poisson": ("k P", "closed"), "poisson_log": ("k R", "closed"),
    "neg_binomial_2": ("k P P", "closed"), "neg_binomial_2_log": ("k R P", "closed"),
    "categorical": ("c s", "closed"), "categorical_logit": ("c r", "closed"),
    "dirichlet": ("s p", "closed"), "multi_normal": ("r r S", "closed"),
    "multi_normal_cholesky": ("r r L", "closed"), "lkj_corr_cholesky": ("LC P", "closed"),
    "ordered_logistic": ("C3 r o", "closed"), "multinomial": ("m3 s", "closed"),
    "multinomial_logit": ("m3 r", "closed"), "beta_binomial": ("k3 4 P P", "closed"),
    "von_mises": ("r R P", "closed"), "skew_normal": ("r R P R", "closed"),
    "frechet": ("p P P", "closed"), "rayleigh": ("p P", "closed"),
    "lkj_corr": ("Q P", "closed"), "wishart": ("W g2 S", "closed"),
    "inv_wishart": ("W g2 S", "closed"), "multi_student_t": ("r P r S", "closed"),
    "exp_mod_normal": ("r R P P", "closed"),
    "skew_double_exponential": ("r R P h", "closed"),
    "beta_proportion": ("u U P", "closed"), "ordered_probit": ("C3 r o", "closed"),
    "normal_id_glm": ("r4 X R r P", "closed"), "bernoulli_logit_glm": ("b4 X R r", "closed"),
    "poisson_log_glm": ("y4 X R r", "closed"), "neg_binomial_2_log_glm": ("y4 X R r P", "closed"),
    "ordered_logistic_glm": ("c4 X r o", "closed"), "categorical_logit_glm": ("c4 X r M", "closed"),
    "inv_chi_square": ("p P", "closed"), "scaled_inv_chi_square": ("p P P", "closed"),
    "pareto_type_2": ("p R0 P P", "closed"), "multi_normal_prec": ("r r S", "closed"),
    "multi_student_t_cholesky": ("r P r L", "closed"), "neg_binomial": ("k P P", "closed"),
    "hypergeometric": ("3 5 6 8", "closed"), "discrete_range": ("C3 1 3", "closed"),
    "wiener": ("t P tau U R", "closed"),
}
ARGS.update({
    "g2": lambda: float(_RNG.uniform(4.0, 6.0)),
    "r4": lambda: _RNG.normal(size=4),
    "b4": lambda: np.array([0, 1, 1, 0], np.int64),
    "R0": lambda: -0.2,
    "5": lambda: 5, "6": lambda: 6, "8": lambda: 8, "4": lambda: 4,
    # beta-binomial counts whose log-beta arguments stay below 8, where
    # JAX's betaln is right (ROADMAP queue 3)
    "k3": lambda: np.array([0, 2, 3], np.int64),
})

CDFS = {
    "normal": ("r R P", "closed"), "exponential": ("p P", "closed"),
    "uniform": ("u neg P", "closed"), "logistic": ("r R P", "closed"),
    "cauchy": ("r R P", "closed"), "lognormal": ("p R P", "closed"),
    "gumbel": ("r R P", "closed"), "weibull": ("p P P", "closed"),
    "gamma": ("p P P", "series"), "student_t": ("r P R P", "series"),
    "beta": ("u P P", "series"), "chi_square": ("p P", "series"),
    "inv_chi_square": ("p P", "series"), "scaled_inv_chi_square": ("p P P", "series"),
    "inv_gamma": ("p P P", "series"), "double_exponential": ("r R P", "closed"),
    "pareto": ("g pos P", "closed"), "pareto_type_2": ("p R0 P P", "closed"),
    "frechet": ("p P P", "closed"), "rayleigh": ("p P", "closed"),
    "std_normal": ("r", "closed"), "exp_mod_normal": ("r R P P", "closed"),
    "poisson": ("k P", "series"), "binomial": ("k N U", "series"),
    "neg_binomial_2": ("k P P", "series"), "bernoulli": ("b U", "closed"),
    "skew_normal": ("r R P h", "series"), "skew_double_exponential": ("r R P h", "closed"),
    "beta_proportion": ("u U P", "series"), "neg_binomial": ("k P P", "series"),
    "beta_binomial": ("K 4 P P", "closed"),
}

FUNCS = {
    "abs": "r", "fabs": "r", "fmin": "r r", "fmax": "r r", "min": "r", "max": "r",
    "sqrt": "p", "cbrt": "p", "square": "r", "exp": "r", "exp2": "r", "expm1": "r",
    "log": "p", "log2": "p", "log10": "p", "log1p": "p", "log1m": "u", "log1p_exp": "r",
    "log1m_exp": "negv", "log_diff_exp": "g p0", "log_inv_logit": "r",
    "log1m_inv_logit": "r", "inv": "p", "inv_sqrt": "p", "inv_square": "p",
    "inv_logit": "r", "logit": "u", "pow": "p r", "hypot": "r r", "floor": "r",
    "ceil": "r", "round": "r", "trunc": "r", "fmod": "r p", "fdim": "r r", "step": "r",
    "int_step": "r", "sin": "r", "cos": "r", "tan": "r", "asin": "u", "acos": "u",
    "atan": "r", "atan2": "r r", "sinh": "r", "cosh": "r", "tanh": "r", "asinh": "r",
    "acosh": "g", "atanh": "u", "lgamma": "p", "tgamma": "p", "digamma": "p",
    "lmgamma": "3 g", "lbeta": "p p", "binomial_coefficient_log": "g u",
    "lchoose": "g u", "lmultiply": "r p", "multiply_log": "r p", "erf": "r",
    "erfc": "r", "Phi": "r", "Phi_approx": "r", "inv_Phi": "u", "sum": "r",
    "prod": "r", "mean": "r", "sd": "r", "variance": "r", "log_sum_exp": "r",
    "softmax": "r", "log_softmax": "r", "cumulative_sum": "r", "dot_product": "r r",
    "dot_self": "r", "columns_dot_product": "M M", "rows_dot_product": "M M",
    "distance": "r r", "squared_distance": "r r", "sort_asc": "r", "sort_desc": "r",
    "reverse": "r", "rep_vector": "R 3", "rep_row_vector": "R 3", "rep_matrix": "R 2 3",
    "rep_array": "r 2", "to_vector": "M", "to_row_vector": "r", "to_array_1d": "M",
    "to_matrix": "v6 2 3", "linspaced_vector": "5 neg P", "to_int": "r",
    "ones_vector": "3", "zeros_vector": "3", "ones_row_vector": "3",
    "zeros_row_vector": "3", "identity_matrix": "3", "head": "r 2", "tail": "r 2",
    "segment": "v6 2 3", "append_row": "r r", "append_col": "r r",
    "diag_matrix": "r", "diagonal": "M", "transpose": "M", "inverse": "S",
    "cholesky_decompose": "S", "determinant": "S", "log_determinant": "S",
    "trace": "M", "quad_form": "S M", "quad_form_diag": "M p", "diag_pre_multiply": "p M",
    "diag_post_multiply": "M p", "multiply_lower_tri_self_transpose": "L",
    "mdivide_left_tri_low": "L r", "mdivide_right_tri_low": "rv L", "mdivide_left": "S r",
    "hmm_marginal": "lo G s", "hmm_hidden_state_prob": "lo G s", "log_mix": "U r r",
    "inc_beta": "P P u", "gamma_p": "P p", "gamma_q": "P p", "trigamma": "p",
    "choose": "N 3", "falling_factorial": "g 1", "rising_factorial": "g 2",
    "log_falling_factorial": "g 1", "log_rising_factorial": "g 2", "inv_cloglog": "r",
    "cloglog": "u", "fma": "r r r", "ldexp": "r 3", "erf_inv": "u", "inv_erfc": "u",
    "matrix_exp": "M", "eigenvalues_sym": "S", "eigenvectors_sym": "S",
    "qr_thin_Q": "X", "qr_thin_R": "X", "qr_Q": "X", "qr_R": "X",
    "singular_values": "X", "svd_U": "X", "svd_V": "X", "generalized_inverse": "X",
    "crossprod": "X", "tcrossprod": "X", "pi": "", "e": "", "sqrt2": "",
    "machine_precision": "", "positive_infinity": "", "negative_infinity": "",
    "not_a_number": "", "owens_t": "r u", "trace_quad_form": "S M", "rank": "r 2",
    "sort_indices_asc": "r", "sort_indices_desc": "r", "uniform_simplex": "3",
    "to_array_2d": "M", "std_normal_log_qf": "negv",
}
ARGS.update({
    "negv": lambda: -_RNG.uniform(0.2, 3.0, 3),
    "p0": lambda: _RNG.uniform(0.1, 1.0, 3),
})
FUNC_SERIES = {"inc_beta", "gamma_p", "gamma_q", "owens_t"}
# a sign or order of the factors is a choice of the library: compare |x|
SIGN_FREE = {"eigenvectors_sym", "qr_thin_Q", "qr_thin_R", "qr_Q", "qr_R", "svd_U", "svd_V"}
# not differentiable (integer or piecewise-constant results)
NO_GRAD = {"floor", "ceil", "round", "trunc", "step", "int_step", "to_int", "choose",
           "rank", "sort_indices_asc", "sort_indices_desc"} | SIGN_FREE


def _make(kinds: str, seed: int):
    global _RNG
    _RNG = np.random.default_rng(seed)
    return [ARGS[k]() for k in kinds.split()]


def _jax_arg(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _torch_arg(a, grad=False):
    if isinstance(a, np.ndarray):
        t = torch.tensor(a)
    elif isinstance(a, float) and grad:
        t = torch.tensor(a, dtype=torch.float64)
    else:
        return a
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), (what, got, want)
    if fin.any():
        scale = max(1.0, float(np.abs(want[fin]).max()))
        err = float(np.abs(got[fin] - want[fin]).max()) / scale
        assert err <= rtol, f"{what}: {err:.3g} > {rtol:g} ({got} vs {want})"


def _check(jfn, tfn, args, rtol, grad_rtol, grad=True, sign_free=False):
    jout = jfn(*[_jax_arg(a) for a in args])
    with xp.evaluation(torch.float64, "cpu"):
        targs = [_torch_arg(a, grad) for a in args]
        tout = tfn(*targs)
        if isinstance(jout, tuple):
            jout, tout = jout[0], tout[0]
        j = np.asarray(jout)
        t = tout.detach().numpy() if isinstance(tout, torch.Tensor) else np.asarray(tout)
        if sign_free:
            j, t = np.abs(j), np.abs(t)
        _close(t, j, rtol, "value")
        if not grad:
            return
        for i, a in enumerate(args):
            if not (isinstance(a, float) or (isinstance(a, np.ndarray) and a.dtype.kind == "f")):
                continue

            def f(x, i=i):
                full = [_jax_arg(b) for b in args]
                full[i] = x
                return jnp.sum(jnp.asarray(jfn(*full), jnp.float64))

            try:
                gj = np.asarray(jax.grad(f)(jnp.asarray(a, jnp.float64)))
            except Exception:
                continue  # JAX gives no gradient here (betainc in a, b)
            if not np.all(np.isfinite(gj)):
                continue
            targs2 = [_torch_arg(b, grad=(k == i)) for k, b in enumerate(args)]
            out = xp.asarray(tfn(*targs2))
            gt = (torch.autograd.grad(out.to(torch.float64).sum(), targs2[i],
                                      allow_unused=True)[0] if out.requires_grad else None)
            gt = np.zeros_like(gj) if gt is None else gt.numpy()
            _close(gt, gj, grad_rtol, f"gradient in argument {i}")


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution(name):
    kinds, tol = DISTS[name]
    assert set(J.DISTRIBUTIONS) == set(T.DISTRIBUTIONS) == set(DISTS)
    args = _make(kinds, zlib.crc32(name.encode()))
    series = tol == "series"
    _check(J.DISTRIBUTIONS[name], T.DISTRIBUTIONS[name], args,
           1e-9 if series else 1e-12, 1e-7 if series else 1e-10)


@pytest.mark.parametrize("table", ["LCDFS", "LCCDFS"])
@pytest.mark.parametrize("name", sorted(CDFS))
def test_cdf(table, name):
    kinds, tol = CDFS[name]
    assert set(getattr(J, table)) == set(getattr(T, table)) == set(CDFS)
    args = _make(kinds, zlib.crc32(name.encode()))
    series = tol == "series"
    _check(getattr(J, table)[name], getattr(T, table)[name], args,
           1e-9 if series else 1e-12, 1e-7 if series else 1e-10)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_function(name):
    assert set(J.FUNCTIONS) == set(T.FUNCTIONS) == set(FUNCS)
    args = _make(FUNCS[name], zlib.crc32(name.encode()))
    series = name in FUNC_SERIES
    _check(J.FUNCTIONS[name], T.FUNCTIONS[name], args,
           1e-9 if series else 1e-12, 1e-7 if series else 1e-10,
           grad=name not in NO_GRAD and bool(args), sign_free=name in SIGN_FREE)


def test_betainc_has_no_gradient_in_a_and_b():
    """As JAX: the incomplete beta function differentiates in x only."""
    with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
        jax.grad(lambda a: J.FUNCTIONS["inc_beta"](a, 2.0, 0.3))(1.5)
    a = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    with xp.evaluation(torch.float64, "cpu"):
        out = T.FUNCTIONS["inc_beta"](a, 2.0, 0.3)
    with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
        out.backward()


def test_gammainc_gradient_in_a_matches_jax():
    """torch's igamma has no derivative in a; the port's equals JAX's."""
    want = float(jax.grad(lambda a: J.FUNCTIONS["gamma_p"](a, 1.5))(2.0))
    assert math.isclose(want, -0.31349, abs_tol=5e-6)
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    with xp.evaluation(torch.float64, "cpu"):
        T.FUNCTIONS["gamma_p"](a, 1.5).backward()
    assert math.isclose(float(a.grad), want, rel_tol=1e-9)


def test_softplus_keeps_its_value_past_torchs_threshold():
    """``log1p_exp`` is log(1 + e^x) everywhere, not torch's switch to x
    above 20 (which differs by about 1.4e-11 at 25)."""
    with xp.evaluation(torch.float64, "cpu"):
        got = float(T.FUNCTIONS["log1p_exp"](torch.tensor(25.0, dtype=torch.float64)))
    assert got == float(J.FUNCTIONS["log1p_exp"](jnp.asarray(25.0)))
    assert got != 25.0
