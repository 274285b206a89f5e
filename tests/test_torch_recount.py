"""The recount gather of the port (sbr_tpu_torch.social.recount) against the
reference's Pallas kernel ``_build_pallas_gather``, on the CPU.

Contracts:

- the plain gathers are bit for bit the reference kernel's interpret mode
  in all three variants (packed, packed with 2-D ids, unpacked), on the
  ablation script's inputs at N = 1000 agents and one edge block
  (131,072 edges);
- `pack_mask` is ``np.packbits(wd, bitorder="little")``;
- the wrappers run the plain versions on CPU tensors and refuse wrong
  dtypes, shapes and devices;
- the port's ablation script checks every variant on the CPU.

The kernel itself is held to the plain versions on the card
(tests/test_torch_cuda.py).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu_torch.benchmarks import ablate_pallas_recount as tabl  # noqa: E402
from sbr_tpu_torch.social import recount  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N = 1000


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "ref_ablate_pallas_recount", REPO / "benchmarks" / "ablate_pallas_recount.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _reference_script()


@pytest.fixture(scope="module")
def inputs(ref):
    assert tabl.EDGE_BLOCK == ref.EDGE_BLOCK
    wd, src, tensors = tabl.make_inputs(N, ref.EDGE_BLOCK, "cpu")
    return wd, src, tensors


@pytest.mark.parametrize("variant", ["packed", "packed_2d", "unpacked"])
def test_plain_gather_equals_reference_interpret_kernel(ref, inputs, variant):
    wd, src, t = inputs
    e_pad = src.shape[0]
    n8 = wd.shape[0]
    packed = variant != "unpacked"
    two_d = variant == "packed_2d"
    kernel = ref._build_pallas_gather(n8 // 8 if packed else n8, e_pad, interpret=True,
                                      packed=packed, two_d=two_d)
    mask = np.packbits(wd, bitorder="little") if packed else wd.astype(np.uint8)
    ids = src.reshape(-1, 128) if two_d else src
    want = np.asarray(jax.block_until_ready(kernel(jnp.asarray(mask), jnp.asarray(ids))))
    ids_t = torch.from_numpy(ids)
    if packed:
        got = recount.bit_gather_plain(t["packed"], ids_t)
        wrapped = recount.bit_gather(t["packed"], ids_t)
    else:
        got = recount.bool_gather_plain(t["wd_u8"], ids_t)
        wrapped = recount.bool_gather(t["wd_u8"], ids_t)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(wrapped, got)
    assert np.array_equal(want.reshape(-1), wd[src].astype(np.int32))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000, 4099])
def test_pack_mask_is_numpy_packbits(n):
    wd = np.random.default_rng(n).random(n) < 0.4
    got = recount.pack_mask(torch.from_numpy(wd))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.packbits(wd, bitorder="little"))


def test_wrappers_refuse_what_the_kernel_does_not_take(inputs):
    _, _, t = inputs
    src = t["src"]
    with pytest.raises(ValueError, match="uint8"):
        recount.bit_gather(t["wd_i32"], src)
    with pytest.raises(ValueError, match="int32"):
        recount.bool_gather(t["wd_u8"], src.to(torch.int64))
    with pytest.raises(ValueError, match="1-D"):
        recount.bit_gather(t["packed"].reshape(-1, 5), src)
    with pytest.raises(ValueError, match="share a device"):
        recount.bit_gather(t["packed"], src.to("meta"))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        recount.bool_gather(t["wd_u8"].to("meta"), src.to("meta"))


def test_plain_gather_raises_on_ids_outside_the_mask():
    packed = recount.pack_mask(torch.ones(16, dtype=torch.bool))
    with pytest.raises(IndexError):
        recount.bit_gather(packed, torch.tensor([16 * 8], dtype=torch.int32))
    with pytest.raises(IndexError):
        recount.bool_gather(torch.ones(16, dtype=torch.uint8), torch.tensor([-1], dtype=torch.int32))


def test_ablation_script_checks_every_variant_on_the_cpu(tmp_path):
    out = tmp_path / "abl.json"
    assert tabl.main(["1003", "20000", "--device", "cpu", "--json", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["n_edges"] == tabl.EDGE_BLOCK
    assert record["packed_mask_bytes"] == 126
    assert set(record["results"]) == set(tabl.VARIANTS)
    assert all(r["mismatches"] == 0 and r["ms"] is None for r in record["results"].values())
