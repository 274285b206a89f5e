"""HTTP exposition and the query route of the serving engine: the port of
``sbr_tpu.serve.endpoint`` (`ServeEndpoint`, `query_result_doc`).

A stdlib-only (``http.server``) thread serving four routes off an
`Engine`:

- ``GET /metrics``: Prometheus text exposition 0.0.4 (lifetime counters,
  window gauges, the cumulative latency histogram, the CUDA-graph
  counters);
- ``GET /healthz``: JSON ready/degraded/unhealthy with reasons; HTTP 200
  for ready and degraded, 503 for unhealthy;
- ``GET /statz``: the full JSON live snapshot;
- ``POST /query``: a JSON parameter document (``make_model_params``
  keywords, e.g. ``{"beta": 1.2, "u": 0.3}``, plus an optional
  ``scenario`` tag) answered with one served equilibrium. A ``scenario``
  object (a `scenario.ScenarioSpec` document) routes the query through
  `Engine.query_scenario`, a ``population`` object through
  `Engine.query_population`. The deadline rides the
  ``X-SBR-Deadline-Ms`` header (or a ``deadline_ms`` field); a query shed
  at admission gets ``429`` with a ``Retry-After`` header, a failed
  dispatch ``503``, a malformed document ``400``. As in the reference, a
  bad spec, a spec the params cannot serve, ``population`` beside
  ``scenario``, ``grads`` on either, and a modifier's knob without its
  modifier are all ``400``. ``"grads": true`` on a plain query answers
  with dξ/d{β, u, κ} (``grads``) and ``grad_flags`` beside ξ.

Tracing headers wait for ``obs.trace`` (ROADMAP item 1.A 9). ``port=0``
binds an ephemeral port; the bound port is `.port`.
"""

from __future__ import annotations

import json
import math
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from sbr_tpu_torch.models.params import make_interest_params, make_model_params
from sbr_tpu_torch.scenario import ScenarioSpec
from sbr_tpu_torch.serve.engine import DeadlineExceeded

# The make_model_params keywords a /query document may carry (anything
# else is 400: a typo like "bta" must not silently serve defaults); ``r``
# and ``delta`` are the reference's interest-rate keywords.
_PARAM_KEYS = (
    "beta", "eta", "eta_bar", "u", "p", "kappa", "lam", "tspan", "x0",
    "insurance_cap", "suspension_t", "lolr_rate", "r", "delta",
)
# Keywords consumed only by a scenario modifier: without the matching
# scenario object the plain solve would ignore them while fingerprinting
# them, so they are a 400, as in the reference.
_GATED = {
    "r": "interest", "delta": "interest", "insurance_cap": "insurance_cap",
    "suspension_t": "suspension", "lolr_rate": "lolr",
}


def _json_safe(value):
    """JSON floats cannot carry NaN/Inf: encode them as None."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def query_result_doc(result) -> dict:
    """The wire form of one `QueryResult`."""
    doc = {
        "xi": _json_safe(result.xi),
        "tau_bar_in": _json_safe(result.tau_bar_in),
        "aw_max": _json_safe(result.aw_max),
        "status": int(result.status),
        "flags": int(result.flags),
        "residual": _json_safe(result.residual),
        "source": result.source,
        "degraded": bool(result.degraded),
        "scenario": result.scenario,
        "latency_ms": round(result.latency_s * 1e3, 3),
    }
    # sensitivities only on grads answers: plain answers stay grad-free
    if result.grads is not None:
        doc["grads"] = {k: _json_safe(v) for k, v in result.grads.items()}
    if result.grad_flags is not None:
        doc["grad_flags"] = int(result.grad_flags)
    return doc


class ServeEndpoint:
    """Expose ``engine`` over HTTP on a daemon thread."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0) -> None:
        self.engine = engine
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # access logs go to stderr
                print(f"[serve.endpoint] {fmt % args}", file=sys.stderr)

            def _send(self, code: int, body: bytes, ctype: str, headers=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, doc: dict, headers=None) -> None:
                self._send(code, json.dumps(doc).encode(), "application/json", headers)

            def do_POST(self):
                try:
                    if self.path.split("?", 1)[0] != "/query":
                        self._json(404, {"error": "not found"})
                        return
                    self._query()
                except BrokenPipeError:
                    pass
                except Exception as err:  # the route must never kill serving
                    try:
                        self._json(500, {"error": repr(err)})
                    except Exception:
                        pass

            def _query(self):
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    doc = json.loads(self.rfile.read(n).decode() or "{}")
                    if not isinstance(doc, dict):
                        raise ValueError("query body must be a JSON object")
                except (ValueError, UnicodeDecodeError) as err:
                    self._json(400, {"error": f"bad query body: {err}"})
                    return
                deadline_ms = None
                raw = self.headers.get("X-SBR-Deadline-Ms")
                try:
                    if raw is not None:
                        deadline_ms = float(raw)
                    elif doc.get("deadline_ms") is not None:
                        deadline_ms = float(doc["deadline_ms"])
                except (TypeError, ValueError):
                    self._json(400, {"error": "bad deadline"})
                    return
                # ``scenario`` is a free-form tag, or a ScenarioSpec document
                # that routes the query through the scenario engine
                scenario_doc = doc.get("scenario")
                spec = None
                if isinstance(scenario_doc, dict):
                    try:
                        spec = ScenarioSpec.from_doc(scenario_doc)
                    except (TypeError, ValueError) as err:
                        self._json(400, {"error": f"bad scenario: {err}"})
                        return
                scenario = "default" if spec is not None else str(scenario_doc or "default")
                population_doc = doc.get("population")
                if population_doc is not None and spec is not None:
                    self._json(400, {"error": "population and scenario are mutually exclusive"})
                    return
                grads = bool(doc.get("grads", False))
                if grads and population_doc is not None:
                    self._json(400, {"error": "grads are not supported on population queries"})
                    return
                if grads and spec is not None:
                    self._json(400, {"error": "grads are not supported on scenario queries"})
                    return
                unknown = (
                    set(doc) - set(_PARAM_KEYS)
                    - {"scenario", "deadline_ms", "grads", "population"}
                )
                if unknown:
                    self._json(400, {"error": f"unknown parameter(s): {sorted(unknown)}"})
                    return
                try:
                    kw = {k: doc[k] for k in _PARAM_KEYS if k in doc}
                    active = spec.modifiers if spec is not None else ()
                    orphaned = sorted(k for k, mod in _GATED.items()
                                      if k in kw and mod not in active)
                    if orphaned:
                        raise ValueError(
                            f"parameter(s) {orphaned} require a scenario object with the "
                            f"matching modifier(s) ({sorted({_GATED[k] for k in orphaned})})"
                        )
                    if "tspan" in kw:
                        kw["tspan"] = tuple(float(v) for v in kw["tspan"])
                    interest = "r" in kw or "delta" in kw
                    maker = make_interest_params if interest else make_model_params
                    params = maker(**kw)
                except (TypeError, ValueError) as err:
                    self._json(400, {"error": f"bad parameters: {err}"})
                    return
                try:
                    if population_doc is not None:
                        try:
                            rec = endpoint.engine.query_population(
                                params, population_doc, deadline_ms=deadline_ms
                            )
                        except (TypeError, ValueError) as err:
                            # a malformed population object is the client's
                            # error: 400, never a retryable 503
                            self._json(400, {"error": f"bad population query: {err}"})
                            return
                        self._json(200, rec)
                        return
                    if spec is not None:
                        try:
                            rec = endpoint.engine.query_scenario(
                                params, spec, deadline_ms=deadline_ms
                            )
                        except (TypeError, ValueError) as err:
                            # spec × params incompatible (the composition
                            # matrix): no worker can serve it, so 400
                            self._json(400, {"error": f"unservable scenario: {err}"})
                            return
                        self._json(200, rec)
                        return
                    result = endpoint.engine.query(
                        params, scenario=scenario, deadline_ms=deadline_ms, grads=grads
                    )
                except DeadlineExceeded as err:
                    self._json(
                        429,
                        {"error": "deadline", "detail": str(err),
                         "retry_after_s": err.retry_after_s},
                        {"Retry-After": f"{err.retry_after_s:g}"},
                    )
                    return
                except Exception as err:
                    # Solver down: an honest 503 a router can fail over on.
                    self._json(503, {"error": "dispatch failed", "detail": repr(err)})
                    return
                self._json(200, query_result_doc(result))

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        self._send(
                            200,
                            endpoint.engine.prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        doc = endpoint.engine.healthz()
                        self._json(503 if doc.get("status") == "unhealthy" else 200, doc)
                    elif path == "/statz":
                        self._send(
                            200,
                            json.dumps(endpoint.engine.statz(), default=str).encode(),
                            "application/json",
                        )
                    else:
                        self._json(404, {"error": "not found"})
                except BrokenPipeError:
                    pass  # the client went away mid-write
                except Exception as err:  # exposition must never kill serving
                    try:
                        self._json(500, {"error": repr(err)})
                    except Exception:
                        pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = int(self.httpd.server_address[1])
        self._started = False
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="sbr-serve-http", daemon=True
        )

    def start(self) -> "ServeEndpoint":
        self._started = True
        self._thread.start()
        return self

    def close(self) -> None:
        try:
            if self._started:
                # shutdown() handshakes with a running serve_forever loop;
                # on a never-started server it would deadlock, so only the
                # socket is released there.
                self.httpd.shutdown()
                self._thread.join(timeout=30.0)
            self.httpd.server_close()
        except Exception:
            pass

    def __enter__(self) -> "ServeEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
