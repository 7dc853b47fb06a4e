"""Closed-form renewal analytics from the Metronome paper (Sec 4 + App C).

Every public function implements a numbered equation from the paper.  All
functions are pure and accept scalars or numpy arrays; they are used by the
adaptive controller (host control plane), the discrete-event simulator, and
the property tests that cross-validate simulation against analysis.

Notation (paper Fig 3/4):
  V        vacation period — all M pollers asleep, arrivals accumulate
  B        busy period     — one poller (the trylock winner) drains the queue
  rho      offered load lambda/mu
  T_S      "short" wake timeout used by *primary* threads
  T_L      "long"  wake timeout used by *backup*  threads (T_L >> T_S)
  M        number of deployed Metronome pollers
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "busy_period_mean",
    "rho_from_periods",
    "ewma_rho",
    "vacation_cdf_high",
    "vacation_pdf_high",
    "mean_vacation_high",
    "backup_success_prob",
    "vacation_cdf_low",
    "mean_vacation_low",
    "mean_vacation_general",
    "mean_vacation_general_approx",
    "adaptive_ts",
    "primary_prob",
    "second_moment_vacation_high",
    "mean_sojourn_high",
]

_EPS = 1e-12


def busy_period_mean(v, rho):
    """Eq (3): E[B|V] = V * rho / (1 - rho), the vacation fixed point.

    Derived from B = (N_V + N_B)/mu with N ~ lambda*T (Little).  Diverges as
    rho -> 1 (saturation); callers must keep rho < 1.
    """
    rho = np.asarray(rho, dtype=np.float64)
    return np.asarray(v, dtype=np.float64) * rho / np.maximum(1.0 - rho, _EPS)


def rho_from_periods(b, v):
    """Eq (4): rho = E[B|V] / (V + E[B|V]) — the observable load estimator."""
    b = np.asarray(b, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    return b / np.maximum(v + b, _EPS)


def ewma_rho(rho_prev, b, v, alpha):
    """Eq (10): rho(i) = (1-alpha) rho(i-1) + alpha * B(i)/(V(i)+B(i))."""
    return (1.0 - alpha) * rho_prev + alpha * rho_from_periods(b, v)


# ---------------------------------------------------------------------------
# High-load regime: 1 primary, M-1 decorrelated backups (Sec 4.2.2)
# ---------------------------------------------------------------------------

def vacation_cdf_high(x, t_s, t_l, m):
    """Eq (5): CDF of V = min(T_S, U_1..U_{M-1}), U ~ Uniform(0, T_L).

    Valid under the decorrelation assumption (verified in paper Fig 5 and in
    tests/test_core_simulator.py against the discrete-event simulator).
    """
    x = np.asarray(x, dtype=np.float64)
    cdf = 1.0 - (1.0 - np.clip(x / t_l, 0.0, 1.0)) ** (m - 1)
    return np.where(x >= t_s, 1.0, cdf)


def vacation_pdf_high(x, t_s, t_l, m):
    """Eq (9): density of Eq (5) on x < T_S (excludes the atom at T_S)."""
    x = np.asarray(x, dtype=np.float64)
    pdf = (m - 1) / t_l * (1.0 - np.clip(x / t_l, 0.0, 1.0)) ** (m - 2)
    return np.where(x < t_s, pdf, 0.0)


def mean_vacation_high(t_s, t_l, m):
    """Eq (6): E[V] = T_L/M * (1 - (1 - T_S/T_L)^M)."""
    return t_l / m * (1.0 - (1.0 - t_s / t_l) ** m)


def backup_success_prob(t_s, t_l, m):
    """Eq (7): P(a backup wakes inside the primary's T_S window).

    NOTE — the paper's printed right-hand side reads
    ``(1 - T_S/T_L)^{M-1} / (M-1)`` which does not equal its own integral
    (check M=2: integral = T_S/T_L).  We implement the integral:
        P = (1 - (1 - T_S/T_L)^{M-1}) / (M-1).
    """
    if m < 2:
        raise ValueError("backup_success_prob needs M >= 2")
    return (1.0 - (1.0 - t_s / t_l) ** (m - 1)) / (m - 1)


# ---------------------------------------------------------------------------
# Low-load regime: all threads primary (Sec 4.2.3)
# ---------------------------------------------------------------------------

def vacation_cdf_low(x, t_s, m):
    """Eq (8): Eq (5) with T_L = T_S and M competitors.

    NOTE — integrating this CDF yields E[V] = T_S/(M+1) exactly (min of M
    uniforms); the paper's stated low-load mean T_S/M instead follows from
    the App C general form at p=1 (M-1 uniforms plus the finishing
    primary's deterministic T_S).  The adaptation rule (Eq 11/12) uses the
    T_S/M convention, which `mean_vacation_low` returns.
    """
    x = np.asarray(x, dtype=np.float64)
    return 1.0 - (1.0 - np.clip(x / t_s, 0.0, 1.0)) ** m


def mean_vacation_low(t_s, m):
    """Sec 4.2.3 (paper convention, used by Eq 11/12): E[V] = T_S / M."""
    return t_s / m


# ---------------------------------------------------------------------------
# General load (Appendix C)
# ---------------------------------------------------------------------------

def primary_prob(rho):
    """App C: p = 1 - rho — probability a thread last saw the queue idle."""
    return 1.0 - np.asarray(rho, dtype=np.float64)


def mean_vacation_general(t_s, t_l, m, p):
    """App C exact E[V] (before the T_L >> T_S approximation).

    E[V] = [1 - ((1-p)(1 - T_S/T_L))^M] / [M * (p/T_S + (1-p)/T_L)]

    NOTE — the paper's printed denominator swaps T_S and T_L; the printed
    form fails its own high-load limit (p->0 must recover Eq (6)).  The
    version here satisfies both limits:
      p -> 0:  E[V] -> T_L/M (1 - (1 - T_S/T_L)^M)   == Eq (6)
      p -> 1:  E[V] -> T_S/M * (1 - 0)/1 ... -> T_S/M == Eq (8) mean
    (verified in tests/test_core_analytics.py).
    """
    p = np.asarray(p, dtype=np.float64)
    num = 1.0 - ((1.0 - p) * (1.0 - t_s / t_l)) ** m
    den = m * (p / t_s + (1.0 - p) / t_l)
    return num / np.maximum(den, _EPS)


def mean_vacation_general_approx(t_s, m, p):
    """Eq (13): E[V] ~= T_S/M * (1 - (1-p)^M)/p   (assumes T_L >> T_S)."""
    p = np.asarray(p, dtype=np.float64)
    safe_p = np.maximum(p, _EPS)
    val = t_s / m * (1.0 - (1.0 - safe_p) ** m) / safe_p
    # p -> 0 limit is T_S (high load: vacation == primary timeout).
    return np.where(p < _EPS, float(t_s), val)


def adaptive_ts(v_target, rho, m, ts_min=0.0, ts_max=np.inf):
    """Eq (12): T_S = M * V_bar * (1-rho)/(1-rho^M), clamped.

    Computed via the geometric-series sum T_S = M*V_bar / (1+rho+...+
    rho^{M-1}) which is exact, stable at rho -> 1 (limit V_bar) and
    rho -> 0 (limit M*V_bar), and never divides by zero.  Fully
    vectorized: every argument (including ``m``) broadcasts, so the
    batched sweep / calibration layer can evaluate whole grids at once.
    """
    rho = np.clip(np.asarray(rho, dtype=np.float64), 0.0, 1.0)
    m = np.asarray(m, dtype=np.float64)
    # geometric sum sum_{k<M} rho^k, switched to its M limit at rho ~ 1
    near_one = np.abs(1.0 - rho) < 1e-9
    safe_rho = np.where(near_one, 0.5, rho)
    denom = np.where(near_one, m,
                     (1.0 - safe_rho**m) / (1.0 - safe_rho))
    return np.clip(m * np.asarray(v_target, dtype=np.float64) / denom,
                   ts_min, ts_max)


# ---------------------------------------------------------------------------
# Latency closed forms (cross-validation targets for the batched engine)
# ---------------------------------------------------------------------------

def second_moment_vacation_high(t_s, t_l, m):
    """E[V^2] for the high-load vacation V = min(T_S, U_1..U_{M-1}).

    From E[V^2] = 2 * int_0^{T_S} x * (1 - F(x)) dx with the Eq (5)
    survival (1 - x/T_L)^{M-1}; substituting u = 1 - x/T_L gives the
    closed form (c = 1 - T_S/T_L):

        E[V^2] = 2 T_L^2 [ (1 - c^M)/M - (1 - c^{M+1})/(M+1) ]

    M = 1 reduces to T_S^2 (deterministic vacation).
    """
    t_s = np.asarray(t_s, dtype=np.float64)
    t_l = np.asarray(t_l, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    c = 1.0 - t_s / t_l
    return 2.0 * t_l**2 * ((1.0 - c**m) / m - (1.0 - c**(m + 1)) / (m + 1))


def mean_sojourn_high(t_s, t_l, m):
    """All-packet mean time in system, high-load regime: E[V^2]/(2 E[V]).

    Renewal-reward over one (V, B) cycle with fluid drain at mu: the
    queue-depth integral per cycle is lam*V^2 / (2(1-rho)) and the
    packets per cycle are lam*V/(1-rho), so the load terms cancel and
    Little's law leaves the residual-vacation form E[V^2]/(2 E[V]) —
    independent of rho while the system is stable.  This is exactly the
    quantity the simulation engines measure as ``mean_sojourn_us``
    (sampled ``mean_latency_us`` is the vacation-found-packet estimator
    instead, higher by ~(1+rho)).
    """
    ev = mean_vacation_high(t_s, t_l, m)
    return second_moment_vacation_high(t_s, t_l, m) / np.maximum(
        2.0 * ev, _EPS)
