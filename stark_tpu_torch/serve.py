"""Proving and verification service (stdlib HTTP, JSON API).

Counterpart of :mod:`stark_tpu.serve`, with the same API, ceilings and
caps.  A long-lived process pays for the kernel library, the statement
tables and the host libraries once and amortizes them across requests:

    POST /prove   {"model": "rescue"|"fibonacci"|"mimc"|"rescue-chain",
                   ...model params...}
        -> {"proof": hex, "output": [...decimal strings...],
            "proof_bytes": N, "prove_s": t}
    POST /verify  {"model": ..., same params, "proof": hex,
                   "output": [...]}
        -> {"valid": true/false, "verify_s": t}
    GET  /healthz -> {"ok": true, "backend": "...", "models": [...]}

Run:  python -m stark_tpu_torch.serve [--port 8080] [--device cuda|cpu|none]

``--device`` defaults to ``cuda``, as the CLI's does, and finding no CUDA
device is an error; ``cpu`` runs the plain versions of the kernels;
``none`` gives the host prover (the JAX module's default).

* One ``ThreadingHTTPServer`` accepts connections concurrently, but heavy
  work is single-flight: one prove or verify holds ``_work_gate`` at a
  time, and a second request waits at most ``queue_timeout_s``, then gets
  503 + Retry-After.
* Statement-size ceilings (fibonacci / mimc ``steps`` <= 2^16,
  rescue-chain ``hashes`` <= 2^12: the 2^20-point FRI domain) are checked
  and the model cache is looked up BEFORE the gate; a model missing from
  the cache is built only while the gate is held (a chain model's AIR
  takes most of a minute to build on the host), so a build never runs
  beside a prove.
* Model instances are cached per (model, statement shape) in an LRU of
  ``MODEL_CACHE_CAP`` (the key is the client's: an unbounded cache would
  let a client grow memory by iterating step counts).
* Proofs travel as hex, field elements as decimal strings.
* Hostile inputs (malformed JSON, unknown models, bad proofs, bodies over
  64 MB) get 4xx with a reason, never a traceback.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .field import FieldElement
from .params import P

#: default statement-size ceilings (see the module docstring)
MAX_STEPS = 1 << 16
MAX_CHAIN_HASHES = 1 << 12
#: bound on distinct cached (model, statement shape) instances
MODEL_CACHE_CAP = 8
#: largest request body accepted
MAX_BODY_BYTES = 64 << 20
MODELS = ["rescue", "fibonacci", "mimc", "rescue-chain"]


class ServiceError(Exception):
    def __init__(self, status: int, reason: str) -> None:
        super().__init__(reason)
        self.status = status
        self.reason = reason


def _fe(value, name: str) -> FieldElement:
    try:
        return FieldElement(int(str(value)) % P)
    except (TypeError, ValueError):
        raise ServiceError(400, f"bad field element for {name!r}")


def _int(params: dict, name: str, default=None, lo=1, hi=MAX_STEPS) -> int:
    v = params.get(name, default)
    if v is None:
        raise ServiceError(400, f"missing parameter {name!r}")
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise ServiceError(400, f"parameter {name!r} must be an integer")
    if not lo <= v <= hi:
        raise ServiceError(400, f"parameter {name!r} out of range [{lo},{hi}]")
    return v


class ProverService:
    """Model registry, bounded per-statement-shape instance cache and the
    single-flight work gate.  ``device`` is each model's ``device=``: a
    torch device ("cuda", "cpu") or None for the host prover."""

    def __init__(
        self,
        device="cuda",
        max_steps: int = MAX_STEPS,
        max_chain_hashes: int = MAX_CHAIN_HASHES,
        queue_timeout_s: float = 30.0,
    ) -> None:
        if device is not None:
            from .ops.backend import resolve_device

            device = resolve_device(device)
        self.device = device
        self.max_steps = max_steps
        self.max_chain_hashes = max_chain_hashes
        self.queue_timeout_s = queue_timeout_s
        self._models: Dict[tuple, object] = {}
        self._models_lock = threading.Lock()
        #: one heavy computation (prove, verify or model build) at a time
        self._work_gate = threading.Lock()

    # -- models (cached per statement shape) ----------------------------

    def _key(self, kind: str, params: dict) -> Tuple:
        """The cache key of a request; the statement ceilings are checked
        here, before the gate and before any model exists."""
        if kind == "rescue":
            return ("rescue",)
        if kind == "fibonacci":
            return ("fibonacci", _int(params, "steps", hi=self.max_steps))
        if kind == "mimc":
            return ("mimc", _int(params, "steps", hi=self.max_steps))
        if kind == "rescue-chain":
            return ("rescue-chain", _int(params, "hashes", hi=self.max_chain_hashes))
        raise ServiceError(400, f"unknown model {kind!r}")

    def _lookup(self, key: tuple):
        """The cached model of ``key`` (refreshed in the LRU), or None."""
        with self._models_lock:
            model = self._models.pop(key, None)
            if model is not None:
                self._models[key] = model
            return model

    def _model(self, kind: str, key: tuple):
        """The model of ``key``, built and cached on a miss.  Callers hold
        the work gate, so a build never runs beside another computation."""
        model = self._lookup(key)
        if model is not None:
            return model
        model = self._build(kind, key)
        with self._models_lock:
            while len(self._models) >= MODEL_CACHE_CAP:
                self._models.pop(next(iter(self._models)))
            self._models[key] = model
        return model

    def _build(self, kind: str, key: tuple):
        if kind == "rescue":
            from .models.rescue_stark import RescueStark

            return RescueStark(device=self.device)
        if kind == "fibonacci":
            from .models.fibonacci import FibonacciStark

            return FibonacciStark(key[1], device=self.device)
        if kind == "mimc":
            from .models.mimc import MimcStark

            return MimcStark(key[1], device=self.device)
        from .models.rescue_chain import RescueChainStark

        return RescueChainStark(key[1], device=self.device)

    # -- API operations -------------------------------------------------

    def _acquire_work_gate(self) -> None:
        """Admission control: wait up to ``queue_timeout_s`` for the
        single-flight gate, else tell the client to retry later."""
        if not self._work_gate.acquire(timeout=self.queue_timeout_s):
            raise ServiceError(503, "prover busy; retry later (single-flight admission)")

    def _gated(self, kind: str, key: tuple, work):
        """``work(model)`` under the gate; a cache miss builds the model
        there (the lookup before the gate only refreshes the LRU)."""
        cached = self._lookup(key)
        self._acquire_work_gate()
        try:
            return work(cached if cached is not None else self._model(kind, key))
        finally:
            self._work_gate.release()

    def prove(self, req: dict) -> dict:
        kind = req.get("model", "rescue")
        key = self._key(kind, req)  # ceilings enforced HERE, pre-gate
        return self._gated(kind, key, lambda model: self._prove_locked(kind, req, model))

    def _prove_locked(self, kind: str, req: dict, model) -> dict:
        t0 = time.perf_counter()
        if kind == "fibonacci":
            output, proof = model.prove(_fe(req.get("a", 1), "a"), _fe(req.get("b", 1), "b"))
        else:  # rescue, mimc, rescue-chain
            output, proof = model.prove(_fe(req.get("input"), "input"))
        return {
            "proof": proof.hex(),
            "output": [str(output.value)],
            "proof_bytes": len(proof),
            "prove_s": round(time.perf_counter() - t0, 4),
        }

    def verify(self, req: dict) -> dict:
        kind = req.get("model", "rescue")
        key = self._key(kind, req)
        proof_hex = req.get("proof", "")
        if not isinstance(proof_hex, str):
            raise ServiceError(400, "proof must be hex")
        try:
            proof = bytes.fromhex(proof_hex)
        except ValueError:
            raise ServiceError(400, "proof must be hex")
        if not proof:
            raise ServiceError(400, "missing proof")
        outputs = req.get("output")
        if not isinstance(outputs, list) or not outputs:
            raise ServiceError(400, "missing output list")
        return self._gated(kind, key, lambda model: self._verify_locked(kind, req, model, proof, outputs))

    def _verify_locked(self, kind: str, req: dict, model, proof: bytes, outputs: list) -> dict:
        t0 = time.perf_counter()
        if kind == "fibonacci":
            valid = model.verify(_fe(req.get("a", 1), "a"), _fe(req.get("b", 1), "b"), _fe(outputs[0], "output"),
                                 proof)
        elif kind == "mimc":
            valid = model.verify(_fe(req.get("input"), "input"), _fe(outputs[0], "output"), proof)
        else:
            valid = model.verify(_fe(outputs[0], "output"), proof)
        return {"valid": bool(valid), "verify_s": round(time.perf_counter() - t0, 4)}

    def health(self) -> dict:
        return {
            "ok": True,
            "backend": "host" if self.device is None else str(self.device),
            "models": list(MODELS),
        }


def make_server(service: ProverService, host: str, port: int) -> ThreadingHTTPServer:
    """The HTTP server of ``service`` on (host, port); port 0 picks a free one."""
    from .utils import get_logger

    log = get_logger("stark_tpu_torch.serve")

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if status == 503:
                self.send_header("Retry-After", str(int(service.queue_timeout_s) or 1))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through the package's logger
            log.info(fmt % args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.health())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    raise ServiceError(400, "bad Content-Length")
                if length < 0:
                    raise ServiceError(400, "bad Content-Length")
                if length > MAX_BODY_BYTES:
                    raise ServiceError(413, "request too large")
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (json.JSONDecodeError, UnicodeDecodeError):
                    raise ServiceError(400, "malformed JSON")
                if not isinstance(req, dict):
                    raise ServiceError(400, "request must be an object")
                if self.path == "/prove":
                    self._send(200, service.prove(req))
                elif self.path == "/verify":
                    self._send(200, service.verify(req))
                else:
                    raise ServiceError(404, "not found")
            except ServiceError as e:
                self._send(e.status, {"error": e.reason})
            except Exception as e:  # noqa: BLE001 - no tracebacks to clients
                log.exception("request failed")
                self._send(500, {"error": type(e).__name__})

    return ThreadingHTTPServer((host, port), Handler)


def _device_arg(value: str) -> Optional[str]:
    return None if value == "none" else value


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="stark_tpu_torch proving service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", type=_device_arg, default="cuda",
                    help="torch device of the prover (default cuda; 'cpu' runs the plain versions, "
                         "'none' the host prover)")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS,
                    help="fibonacci/mimc statement-size ceiling (default 2^16)")
    ap.add_argument("--max-chain-hashes", type=int, default=MAX_CHAIN_HASHES,
                    help="rescue-chain statement-size ceiling (default 2^12)")
    ap.add_argument("--queue-timeout", type=float, default=30.0,
                    help="seconds a request may wait for the single-flight prover gate before 503 (default 30)")
    args = ap.parse_args(argv)
    service = ProverService(args.device, max_steps=args.max_steps, max_chain_hashes=args.max_chain_hashes,
                            queue_timeout_s=args.queue_timeout)
    server = make_server(service, args.host, args.port)
    print(f"stark_tpu_torch serving on {args.host}:{args.port} ({service.health()['backend']})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
