"""Population-level what-if queries: the port of
``sbr_tpu.infomodels.population``.

A population query asks: at these economics, under this information model,
on this graph family, what is the distribution of run outcomes across
realizations?

`population_query` answers it: it solves the model's mean-field fixed point
once, runs S agent populations through `social.closure.close_loop` (so on
the card every step of every member ends in the CUDA infection kernel,
gossip, or the CUDA belief kernel, bayes), and reduces each member's AW
trajectory to its run-crossing time, the first t with AW(t) ≥ κ. The answer
is the reference's JSON-ready record: crossing-time quantiles
(p10/p50/p90), the run probability, the mean-field ξ and the per-member
crossing times. The serving engine caches it by `population_fingerprint`
(`serve.engine.Engine.query_population`).

Two seed-variation modes:

- ``vary="sim"`` (default): one graph, generated at the base seed and
  prepared once (`close_loop`'s seeds axis), S simulation seeds;
- ``vary="graph"``: S (graph, sim) seed pairs, each member generating its
  own graph on the device, the fixed point shared through ``fp=``.

A ``dynamics="rewire"`` information model runs each member through the
epoch loop of `infomodels.engine.simulate_info`: no graph is shared across
members in either mode, since every epoch regenerates it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from sbr_tpu_torch.infomodels.spec import InfoModelSpec, infomodel_fingerprint
from sbr_tpu_torch.models.params import ModelParams, SolverConfig

POP_VARY = ("sim", "graph")

# Serving guardrail: a wire-supplied seed count multiplies whole agent
# simulations, so it is capped.
MAX_POP_SEEDS = 256


def crossing_times(aw_rows: np.ndarray, t: np.ndarray, kappa: float) -> np.ndarray:
    """Per-member run-crossing time: the first grid time with AW(t) ≥ κ,
    linearly interpolated inside the crossing step; NaN for members that
    never cross (no run in that realization)."""
    aw_rows = np.asarray(aw_rows, np.float64)
    t = np.asarray(t, np.float64)
    out = np.full(aw_rows.shape[0], np.nan)
    for i, aw in enumerate(aw_rows):
        idx = np.nonzero(aw >= kappa)[0]
        if idx.size == 0:
            continue
        j = int(idx[0])
        if j == 0 or aw[j] == aw[j - 1]:
            out[i] = t[j]
        else:
            frac = (kappa - aw[j - 1]) / (aw[j] - aw[j - 1])
            out[i] = t[j - 1] + frac * (t[j] - t[j - 1])
    return out


def population_query(
    spec: InfoModelSpec,
    graph,
    model: ModelParams,
    seeds: int = 16,
    vary: str = "sim",
    seed: int = 0,
    dt: float = 0.1,
    g0: Optional[float] = 0.02,
    config: Optional[SolverConfig] = None,
    fp=None,
    device=None,
) -> dict:
    """Run one population what-if query (module docstring) on ``device``
    (default: the CUDA card) and return the JSON-ready record. ``graph`` is
    a `social.graphgen` spec; ``seeds`` the number of members S (at most
    `MAX_POP_SEEDS`); ``fp`` a fixed point of ``model`` to reuse."""
    from sbr_tpu_torch.social.closure import close_loop

    if vary not in POP_VARY:
        raise ValueError(f"vary must be one of {POP_VARY}, got {vary!r}")
    seeds = int(seeds)
    if not (1 <= seeds <= MAX_POP_SEEDS):
        raise ValueError(f"seeds must be in [1, {MAX_POP_SEEDS}], got {seeds}")
    if spec.channel == "bayes" and g0 is not None:
        # the bayes model bootstraps through its own threshold tail; a mid
        # start adds nothing, so populations run from scratch
        g0 = None

    kappa = float(model.economic.kappa)
    member_seeds = [seed + 1000 * s for s in range(seeds)]
    if vary == "sim":
        comp = close_loop(
            model=model, n_agents=graph.n, dt=dt, g0=g0, seed=seed,
            config=config, graph=graph, infomodel=spec, seeds=member_seeds,
            fp=fp, device=device,
        )
        t = comp.t
        aw_rows = comp.aw_seeds
        fp = comp.fp
        # the S-member mean trajectory against the mean-field curve
        err_aw_sup = comp.err_aw_sup
    else:
        rows = []
        t = None
        err_aw_sup = 0.0
        for ms in member_seeds:
            comp = close_loop(
                model=model, n_agents=graph.n, dt=dt, g0=g0, seed=ms,
                config=config, graph=graph, infomodel=spec,
                seeds=[ms], fp=fp, device=device,
            )
            fp = comp.fp  # solved once, shared by the members
            rows.append(comp.aw_seeds[0])
            t = comp.t
            # the worst member against the curve: each member is its own
            # graph realization
            err_aw_sup = max(err_aw_sup, comp.err_aw_sup)
        aw_rows = np.stack(rows)

    times = crossing_times(aw_rows, t, kappa)
    crossed = np.isfinite(times)
    run_p = float(np.mean(crossed))
    finite = times[crossed]

    def q(p: float) -> Optional[float]:
        if finite.size == 0:
            return None
        return float(np.quantile(finite, p))

    xi_mf = float(fp.xi)
    return {
        "kind": "population",
        "channel": spec.channel,
        "dynamics": spec.dynamics,
        "vary": vary,
        "seeds": seeds,
        "n_agents": int(graph.n),
        "kappa": kappa,
        "run_probability": run_p,
        "crossing_quantiles": {"p10": q(0.10), "p50": q(0.50), "p90": q(0.90)},
        "crossing_times": [
            None if not math.isfinite(v) else round(float(v), 6) for v in times
        ],
        "xi_meanfield": xi_mf if math.isfinite(xi_mf) else None,
        "fp_converged": bool(fp.converged),
        # vary="sim": the member-mean trajectory's error; vary="graph": the
        # worst member's
        "err_aw_sup": round(err_aw_sup, 6),
    }


# -- wire form ---------------------------------------------------------------

GRAPH_MODELS = ("erdos_renyi", "scale_free", "stochastic_block")


def graph_spec_from_doc(doc: dict):
    """Parse the ``population.graph`` wire object into a graphgen spec.
    Unknown models and fields are errors, as in `ScenarioSpec.from_doc`."""
    from sbr_tpu_torch.social import graphgen

    if not isinstance(doc, dict):
        raise ValueError(f"graph must be a JSON object, got {type(doc).__name__}")
    kw = dict(doc)
    m = kw.pop("model", "erdos_renyi")
    makers = {
        "erdos_renyi": graphgen.ErdosRenyiSpec,
        "scale_free": graphgen.ScaleFreeSpec,
        "stochastic_block": graphgen.StochasticBlockSpec,
    }
    if m not in makers:
        raise ValueError(f"unknown graph model {m!r}; expected one of {GRAPH_MODELS}")
    try:
        return makers[m](**kw)
    except TypeError as err:
        raise ValueError(f"bad graph spec: {err}") from err


def parse_population_doc(doc: dict) -> dict:
    """Parse and validate the `POST /query` ``population`` object into the
    `population_query` keywords (specs instantiated, bounds checked).
    Raises ValueError on any malformed field; the endpoint answers 400."""
    if not isinstance(doc, dict):
        raise ValueError(
            f"population must be a JSON object, got {type(doc).__name__}"
        )
    known = {"graph", "infomodel", "seeds", "vary", "seed", "dt", "g0"}
    unknown = set(doc) - known
    if unknown:
        raise ValueError(f"unknown population field(s): {sorted(unknown)}")
    if "graph" not in doc:
        raise ValueError("population requires a 'graph' object")
    graph = graph_spec_from_doc(doc["graph"])
    spec = InfoModelSpec.from_doc(doc.get("infomodel") or {})
    kw = {
        "graph": graph,
        "spec": spec,
        "seeds": int(doc.get("seeds", 16)),
        "vary": str(doc.get("vary", "sim")),
        "seed": int(doc.get("seed", 0)),
        "dt": float(doc.get("dt", 0.1)),
    }
    if "g0" in doc:
        kw["g0"] = None if doc["g0"] is None else float(doc["g0"])
    if kw["vary"] not in POP_VARY:
        raise ValueError(f"vary must be one of {POP_VARY}, got {kw['vary']!r}")
    if not (1 <= kw["seeds"] <= MAX_POP_SEEDS):
        raise ValueError(f"seeds must be in [1, {MAX_POP_SEEDS}]")
    if not (kw["dt"] > 0):
        raise ValueError("dt must be positive")
    return kw


def population_fingerprint(kw: dict, params, config, dtype_name: str) -> str:
    """The cache key of one population query: the parsed spec pair plus
    every value that shapes the answer, through `infomodel_fingerprint`
    (which carries INFOMODEL_PROGRAM_VERSION); its hex equals the
    reference's on the same inputs."""
    extra = (
        kw["graph"], kw["seeds"], kw["vary"], kw["seed"], kw["dt"],
        kw.get("g0", 0.02),
    )
    return infomodel_fingerprint(
        kw["spec"], params=params, config=config, dtype=dtype_name, extra=extra
    )
