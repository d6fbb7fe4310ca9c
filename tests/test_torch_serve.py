"""The port's proving service (stark_tpu_torch.serve) on the CPU.

The eight behaviours ``tests/test_serve.py`` pins for the JAX module
(healthz, the prove/verify round trip, the fibonacci model, hostile
inputs, an oversized statement rejected before the prover and with no
model built, the gate's 503 when busy, the bounded cache), that a cache
miss builds its model only under the gate, and that proofs cross between
the two services' Rescue models both ways.  The server runs in process on
the host prover (``device=None``) or the plain kernel versions
(``device="cpu"``), with small statements.

Tolerance: none (proofs are compared byte for byte, verdicts exactly).
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from stark_tpu_torch.serve import MODEL_CACHE_CAP, ProverService, ServiceError, make_server

torch.set_num_threads(1)


def _start(service):
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def server_url():
    server, url = _start(ProverService(device=None))
    yield url
    server.shutdown()
    server.server_close()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _post_raw(url, path, body: bytes, headers=None):
    req = urllib.request.Request(url + path, data=body, headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def test_healthz(server_url):
    with urllib.request.urlopen(server_url + "/healthz", timeout=30) as r:
        data = json.loads(r.read())
    assert data == {"ok": True, "backend": "host", "models": ["rescue", "fibonacci", "mimc", "rescue-chain"]}


def test_prove_verify_round_trip(server_url):
    status, proved = _post(server_url, "/prove", {"model": "rescue", "input": "12345"})
    assert status == 200 and proved["proof_bytes"] == len(proved["proof"]) // 2 > 1000
    status, verdict = _post(server_url, "/verify",
                            {"model": "rescue", "proof": proved["proof"], "output": proved["output"]})
    assert status == 200 and verdict["valid"] is True
    # a wrong claimed output is an invalid proof, not an error
    status, verdict = _post(server_url, "/verify", {"model": "rescue", "proof": proved["proof"], "output": ["999"]})
    assert status == 200 and verdict["valid"] is False


def test_fibonacci_model_on_the_plain_kernel_versions():
    """A fib-64 round trip through a service on ``device="cpu"``."""
    server, url = _start(ProverService(device="cpu"))
    try:
        status, proved = _post(url, "/prove", {"model": "fibonacci", "steps": 64, "a": "1", "b": "1"})
        assert status == 200
        status, verdict = _post(url, "/verify", {"model": "fibonacci", "steps": 64, "a": "1", "b": "1",
                                                 "proof": proved["proof"], "output": proved["output"]})
        assert status == 200 and verdict["valid"] is True
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["backend"] == "cpu"
    finally:
        server.shutdown()
        server.server_close()


def test_hostile_inputs(server_url):
    assert _post_raw(server_url, "/prove", b"{not json")[0] == 400
    assert _post_raw(server_url, "/prove", b"\xff\xfe")[0] == 400
    assert _post_raw(server_url, "/prove", b"[1, 2]")[0] == 400
    assert _post_raw(server_url, "/prove", json.dumps({"model": "nope"}).encode())[0] == 400
    assert _post_raw(server_url, "/nowhere", b"{}")[0] == 404
    code, body, _ = _post_raw(server_url, "/verify",
                              json.dumps({"model": "rescue", "proof": "zz", "output": ["1"]}).encode())
    assert code == 400 and "error" in body
    assert _post_raw(server_url, "/verify", json.dumps({"model": "rescue", "proof": 7, "output": ["1"]}).encode())[0] \
        == 400
    assert _post_raw(server_url, "/verify", json.dumps({"model": "rescue", "proof": "00"}).encode())[0] == 400
    # garbage proof bytes: a clean invalid, not a traceback
    code, body, _ = _post_raw(server_url, "/verify",
                              json.dumps({"model": "rescue", "proof": "00" * 64, "output": ["1"]}).encode())
    assert code == 200 and body["valid"] is False
    assert _post_raw(server_url, "/prove", json.dumps({"model": "fibonacci", "steps": -4}).encode())[0] == 400
    assert _post_raw(server_url, "/prove", json.dumps({"model": "mimc", "steps": "x"}).encode())[0] == 400
    assert _post_raw(server_url, "/prove", json.dumps({"model": "rescue", "input": [1]}).encode())[0] == 400
    code, body, _ = _post_raw(server_url, "/prove", b"{}", {"Content-Length": str((64 << 20) + 1)})
    assert code == 413 and body["error"] == "request too large"


def test_oversized_statement_rejected_before_prover(server_url):
    code, body, _ = _post_raw(server_url, "/prove", json.dumps({"model": "fibonacci", "steps": 1 << 20}).encode())
    assert code == 400 and "out of range" in body["error"]
    code, body, _ = _post_raw(server_url, "/prove", json.dumps({"model": "rescue-chain", "hashes": 1 << 13}).encode())
    assert code == 400 and "out of range" in body["error"]


def test_oversized_statement_skips_model_construction():
    svc = ProverService(device=None)
    calls = []
    svc._build = lambda kind, key: calls.append(key)  # would record any build
    with pytest.raises(ServiceError) as e:
        svc.prove({"model": "fibonacci", "steps": (1 << 16) + 1})
    assert e.value.status == 400
    assert calls == [] and svc._models == {}


def test_single_flight_gate_503_when_busy():
    svc = ProverService(device=None, queue_timeout_s=0.2)
    server, url = _start(svc)
    try:
        svc._work_gate.acquire()
        try:
            code, _, headers = _post_raw(url, "/prove", json.dumps({"model": "rescue", "input": "1"}).encode())
            assert code == 503 and headers.get("Retry-After") == "1"
        finally:
            svc._work_gate.release()
        status, proved = _post(url, "/prove", {"model": "rescue", "input": "1"})
        assert status == 200 and proved["proof_bytes"] > 1000
    finally:
        server.shutdown()
        server.server_close()


def test_a_cache_miss_builds_its_model_only_under_the_gate():
    svc = ProverService(device=None, queue_timeout_s=0.2)
    built = []

    class Model:
        def prove(self, a, b):
            return a, b"proof"

    def build(kind, key):
        built.append((key, svc._work_gate.locked()))
        return Model()

    svc._build = build
    svc._work_gate.acquire()
    try:  # a miss waits for the gate and builds nothing meanwhile
        with pytest.raises(ServiceError) as e:
            svc.prove({"model": "fibonacci", "steps": 8})
        assert e.value.status == 503 and built == [] and svc._models == {}
    finally:
        svc._work_gate.release()
    assert svc.prove({"model": "fibonacci", "steps": 8})["proof_bytes"] == 5
    svc.prove({"model": "fibonacci", "steps": 8})  # a hit builds nothing
    assert built == [(("fibonacci", 8), True)]


def test_model_cache_bounded():
    svc = ProverService(device=None)
    svc._build = lambda kind, key: object()  # skip real construction
    for i in range(MODEL_CACHE_CAP * 3):
        svc._model("fibonacci", svc._key("fibonacci", {"steps": i + 1}))
    assert len(svc._models) == MODEL_CACHE_CAP
    assert ("fibonacci", MODEL_CACHE_CAP * 3) in svc._models  # LRU: the most recent keys survive
    svc._lookup(("fibonacci", MODEL_CACHE_CAP * 2 + 1))  # a hit refreshes the oldest
    svc._model("fibonacci", ("fibonacci", 1))
    assert ("fibonacci", MODEL_CACHE_CAP * 2 + 1) in svc._models
    assert ("fibonacci", MODEL_CACHE_CAP * 2 + 2) not in svc._models


def test_proofs_cross_between_the_port_and_the_jax_package(server_url):
    """A proof the port's service makes verifies with the JAX package's
    ``RescueStark``, and one the JAX package makes verifies through the
    port's service."""
    from stark_tpu.field import FieldElement
    from stark_tpu.models.rescue_stark import RescueStark

    jax_model = RescueStark()
    status, proved = _post(server_url, "/prove", {"model": "rescue", "input": "777"})
    assert status == 200
    assert jax_model.verify(FieldElement(int(proved["output"][0])), bytes.fromhex(proved["proof"]))
    output, proof = jax_model.prove(FieldElement(4242))
    status, verdict = _post(server_url, "/verify", {"model": "rescue", "proof": proof.hex(),
                                                    "output": [str(output.value)]})
    assert status == 200 and verdict["valid"] is True
