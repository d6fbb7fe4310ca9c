"""The torch port's Rescue, MiMC and Rescue-chain models against the JAX
package's host prover, and the port's CLI against the JAX CLI.

* ``RescueStark`` with no backend (``device=None``) and on
  ``device="cpu"`` (its 512-point domain is host work), single proves and
  ``prove_batch`` of 3 inputs, whose witnesses come from the batched
  permutation's plain version: proof bytes equal the JAX host prover's on
  the same ``DeterministicRandom``;
* ``MimcStark(30)`` and ``RescueChainStark(4)`` with the device pipeline
  forced (its floor lowered to 512 points) on ``device="cpu"`` (the plain
  kernel versions): proof bytes equal the JAX host prover's; the chain
  proof also through the grouped big-AIR verifier;
* ``RescueChainStark(16)`` (448 rows: the device interpolates its trace):
  the model's limb trace gives the bytes of its rows handed to
  ``Stark.prove``, and only the rows are packed on the host;
* the CLI, in process: prove / verify round trips of the rescue, mimc
  and rescue-chain models on ``--device cpu`` with the JAX CLI's proof
  bytes, the refusal of cross-model flags, and ``hash`` and ``inspect``
  printing what the JAX CLI prints.

Tolerance: none (proof bytes are compared exactly).
"""

import json

import pytest
import torch

from stark_tpu.cli import main as jax_cli
from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.models.mimc import MimcStark as JaxMimcStark
from stark_tpu.models.rescue_chain import RescueChainStark as JaxRescueChainStark
from stark_tpu.models.rescue_stark import RescueStark as JaxRescueStark
from stark_tpu.rng import DeterministicRandom as JaxRandom
from stark_tpu_torch import stark as port_stark
from stark_tpu_torch.cli import main as port_cli
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.models.mimc import MimcStark
from stark_tpu_torch.models.rescue_chain import RescueChainStark
from stark_tpu_torch.models.rescue_stark import RescueStark
from stark_tpu_torch.rng import DeterministicRandom
from stark_tpu_torch.utils import profiling

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)

BATCH = (3, 5, 7)


@pytest.fixture(scope="module")
def rescue_batch():
    """The JAX host prover's proofs of BATCH in one transcript sequence;
    the first equals a single prove on a fresh rng."""
    return JaxRescueStark(rng=JaxRandom(5)).prove_batch([JaxFieldElement(x) for x in BATCH])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_rescue_stark_prove_equals_the_jax_host_prover(rescue_batch, device):
    model = RescueStark(device=device, rng=DeterministicRandom(5))
    assert not model.stark._use_device_pipeline()  # 512 points: host work by design
    output, proof = model.prove(FieldElement(BATCH[0]))
    assert (output.value, proof) == (rescue_batch[0][0].value, rescue_batch[0][1])
    assert model.verify(output, proof)
    assert not model.verify(output + FieldElement(1), proof)
    assert not model.verify(output, proof[:-7])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_rescue_stark_prove_batch_equals_the_jax_host_prover(rescue_batch, device):
    model = RescueStark(device=device, rng=DeterministicRandom(5))
    got = model.prove_batch([FieldElement(x) for x in BATCH])
    assert [(o.value, p) for o, p in got] == [(o.value, p) for o, p in rescue_batch]


def test_mimc_device_pipeline_equals_the_jax_host_prover():
    want = JaxMimcStark(30, rng=JaxRandom(8)).prove(JaxFieldElement(777))
    model = MimcStark(30, device="cpu", rng=DeterministicRandom(8))
    model.stark.backend.device_prover_min = 512
    assert model.stark._use_device_pipeline()
    result, proof = model.prove(FieldElement(777))
    assert (result.value, proof) == (want[0].value, want[1])
    assert model.verify(FieldElement(777), result, proof)
    assert not model.verify(FieldElement(778), result, proof)


def test_rescue_chain_device_pipeline_equals_the_jax_host_prover(monkeypatch):
    want = JaxRescueChainStark(4, rng=JaxRandom(21)).prove(JaxFieldElement(77))
    model = RescueChainStark(4, device="cpu", rng=DeterministicRandom(21))
    model.stark.backend.device_prover_min = 512
    assert model.stark._use_device_pipeline()
    output, proof = model.prove(FieldElement(77))
    assert (output.value, proof) == (want[0].value, want[1])
    host = RescueChainStark(4, device=None)
    assert host.verify(output, proof)
    monkeypatch.setattr(port_stark, "BIG_AIR_DICT", 1)  # the grouped verifier
    assert host.verify(output, proof)
    assert model.verify(output, proof)  # grouped, device gathers
    assert not model.verify(output + FieldElement(1), proof)


def test_rescue_chain_limb_trace_proves_the_row_trace_proof(monkeypatch):
    def model():
        m = RescueChainStark(16, device="cpu", rng=DeterministicRandom(21))
        m.stark.backend.device_prover_min = 512
        assert m.stark._use_device_pipeline()
        return m

    def refused(*args, **kwargs):
        raise AssertionError("the device prove called the host trace interpolation")

    monkeypatch.setattr(port_stark.Stark, "_interpolate_trace", refused)
    limbs, rows = model(), model()
    packed = profiling.PACKED_ROW_TRACES
    output, proof = limbs.prove(FieldElement(77))
    assert profiling.PACKED_ROW_TRACES == packed
    trace = rows.air.trace(FieldElement(77))
    assert len(trace) == 448 and output == trace[-1][0]
    assert rows.stark.prove(trace, limbs.constraints, rows.air.boundary_constraints(output)) == proof
    assert profiling.PACKED_ROW_TRACES == packed + 1
    assert limbs.verify(output, proof)


# model -> (prove's flags, verify's flags)
CLI_CASES = {
    "rescue": (["--input", "57322816861100832358702415967512842988"], []),
    "mimc": (["--steps", "30", "--input", "3", "--key", "11"], ["--steps", "30", "--input", "3", "--key", "11"]),
    "rescue-chain": (["--hashes", "2", "--input", "1"], ["--hashes", "2"]),
}


@pytest.mark.parametrize("model", sorted(CLI_CASES))
def test_cli_round_trip_equals_the_jax_cli(tmp_path, capsys, model):
    prove, verify = CLI_CASES[model]
    args = ["--model", model, *prove, "--seed", "4"]
    assert jax_cli(["prove", *args, "--out", str(tmp_path / "jax.bin")]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli(["prove", *args, "--device", "cpu", "--out", str(tmp_path / "port.bin")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["output"], got["proof_bytes"], got["device"]) == (want["output"], want["proof_bytes"], "cpu")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    for claimed, ok in ((got["output"], True), (str(int(got["output"]) + 1), False)):
        rc = port_cli(["verify", "--model", model, *verify, "--device", "cpu", "--output", claimed,
                       "--proof", str(tmp_path / "port.bin")])
        assert (rc, json.loads(capsys.readouterr().out)["valid"]) == (0 if ok else 1, ok)


@pytest.mark.parametrize("argv", [
    ["prove", "--model", "rescue", "--hashes", "4", "--input", "1"],
    ["prove", "--model", "rescue", "--steps", "8", "--input", "1"],
    ["prove", "--model", "fibonacci", "--input", "1"],
    ["prove", "--model", "mimc", "--seed-a", "2", "--input", "1"],
    ["prove", "--model", "rescue-chain", "--key", "3", "--input", "1"],
    ["prove", "--model", "mimc", "--steps", "8"],
    ["verify", "--model", "rescue-chain", "--hashes", "2", "--input", "1", "--output", "5", "--proof", "x"],
])
def test_cli_refuses_flags_of_another_model(tmp_path, argv):
    if argv[0] == "prove":
        argv = [*argv, "--out", str(tmp_path / "p.bin")]
    else:
        (tmp_path / "x").write_bytes(b"")
        argv = [*argv[:-1], str(tmp_path / "x")]
    with pytest.raises(SystemExit):
        port_cli([*argv, "--device", "cpu"])


def test_cli_hash_and_inspect_print_what_the_jax_cli_prints(tmp_path, capsys):
    for value in ("1", "0x2a", "57322816861100832358702415967512842988"):
        assert jax_cli(["hash", "--input", value]) == 0
        want = capsys.readouterr().out
        assert port_cli(["hash", "--input", value]) == 0
        assert capsys.readouterr().out == want
    assert jax_cli(["prove", "--input", "5", "--seed", "1", "--out", str(tmp_path / "p.bin")]) == 0
    (tmp_path / "bad.bin").write_bytes(b"\x05\x00\x00")
    capsys.readouterr()
    for name in ("p.bin", "bad.bin"):
        rc = jax_cli(["inspect", "--proof", str(tmp_path / name)])
        want = capsys.readouterr().out
        assert port_cli(["inspect", "--proof", str(tmp_path / name)]) == rc
        assert capsys.readouterr().out == want
