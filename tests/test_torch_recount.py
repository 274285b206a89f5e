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


# ---------------------------------------------------------------------------
# The kernel's launch plan (recount.plan_launch), with an H100's numbers: 132
# SMs, 232,448 bytes of shared memory a block may opt in to, 233,472 an SM.
# ---------------------------------------------------------------------------

H100 = dict(sms=132, smem_optin=232_448, smem_per_sm=233_472)
E_FULL = 10_092_544


def _plan(mask_bytes, packed, n_edges=E_FULL, **kw):
    return recount.plan_launch(mask_bytes, n_edges, packed=packed, **H100, **kw)


def _whole_capacity(packed):
    """The largest mask whose whole bit table one block holds, by bisection."""
    lo, hi = 0, 16 * H100["smem_optin"]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _plan(mid, packed).name == "shared" else (lo, mid)
    return lo


def test_plan_holds_the_1e6_packed_mask_in_shared_memory():
    plan = _plan(125_000, True)
    assert plan.name == "shared" and plan.cluster == 1 and plan.held == 125_000
    assert recount.TABLE_OFFSET + 125_000 <= plan.smem <= H100["smem_optin"]


@pytest.mark.parametrize("mask_bytes,packed,name,cluster,held", [
    (125_000, True, "shared", 1, 125_000),       # packed, 10^6 agents
    (250_001, True, "split", 1, 232_305),        # packed, 2×10^6 + 3 agents
    (500_000, True, "split", 1, 232_305),        # packed, 4×10^6 agents
    (1_000_000, True, "global", 1, 0),           # packed, 8×10^6 agents
    (1_000_000, False, "shared", 4, 125_000),    # unpacked, 10^6 agents
    (2_000_008, False, "split", 4, 232_320),     # unpacked, 2×10^6 + 3 agents
    (4_000_000, False, "split", 4, 232_320),     # unpacked, 4×10^6 agents
    (8_000_000, False, "global", 1, 0),          # unpacked, 8×10^6 agents
])
def test_plan_routes_the_measured_shapes_by_the_size_rule(mask_bytes, packed, name, cluster,
                                                          held):
    plan = _plan(mask_bytes, packed)
    assert (plan.name, plan.cluster, plan.held) == (name, cluster, held)
    assert plan.threads == recount.THREADS and plan.smem <= H100["smem_optin"]


@pytest.mark.parametrize("packed", [True, False])
def test_one_byte_above_each_capacity_goes_to_the_next_branch(packed):
    per_byte = 1 if packed else 8  # mask bytes a byte of the bit table
    cap = _whole_capacity(packed)
    assert _plan(cap, packed).name == "shared"
    assert _plan(cap + 1, packed).name == "split"
    top = recount.SHARED_MAX_BYTES * per_byte
    assert _plan(top, packed).name == "split"
    assert _plan(top + 1, packed).name == "global"
    # the threshold is the rule's one parameter
    assert _plan(top + 1, packed, shared_max=recount.SHARED_MAX_BYTES + 1).name == "split"
    assert _plan(1, packed, shared_max=0).name == "global"


def test_unpacked_staging_cluster_grows_with_the_mask():
    step = recount.STAGE_BYTES
    assert _plan(step, False).cluster == 1
    assert _plan(step + 1, False).cluster == 2
    assert _plan(2 * step + 1, False).cluster == 4
    assert _plan(4 * step + 1, False).cluster == recount.STAGE_CLUSTERS[-1] == 4
    assert _plan(recount.SHARED_MAX_BYTES, True).cluster == 1  # a packed mask: each block alone


@pytest.mark.parametrize("n_edges", [1, 3, 131_071, 131_072, 300_001, E_FULL])
@pytest.mark.parametrize("mask_bytes,packed", [
    (126, True), (125_000, True), (250_001, True), (1_000_000, True), (1_003, False),
    (600_000, False), (1_000_000, False), (2_000_008, False), (8_000_000, False),
])
def test_grid_never_exceeds_what_is_resident(n_edges, mask_bytes, packed):
    for shared_max in (0, recount.SHARED_MAX_BYTES, 1 << 30):
        plan = _plan(mask_bytes, packed, n_edges, shared_max=shared_max)
        per_sm = min(2048 // plan.threads, H100["smem_per_sm"] // (plan.smem + 1024))
        resident = per_sm * H100["sms"] // plan.cluster * plan.cluster
        assert 1 <= plan.grid <= resident and plan.grid % plan.cluster == 0
        assert recount.TABLE_OFFSET <= plan.smem <= H100["smem_optin"]
        if plan.branch == "shared":
            assert recount.TABLE_OFFSET + 15 * packed + plan.held <= plan.smem
        else:
            assert plan.smem == recount.TABLE_OFFSET and plan.held == 0
        # the occupancy API's count, where smaller, caps the grid too
        small = _plan(mask_bytes, packed, n_edges, shared_max=shared_max,
                      resident=2 * plan.cluster)
        assert small.grid <= 2 * plan.cluster and small.grid % plan.cluster == 0


def test_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError, match="fits on the card"):
        _plan(1_000_000, False, resident=2)
    with pytest.raises(ValueError, match="fits on the card"):
        _plan(1_000, True, resident=0)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_output_shares_the_ids_alignment(offset):
    src = torch.arange(1003, dtype=torch.int32)[offset:]
    out = recount._output_like(src)
    assert out.shape == src.shape and out.dtype == torch.int32 and out.is_contiguous()
    assert (out.data_ptr() - src.data_ptr()) % 16 == 0
    assert recount._output_like(src[:1000].view(8, 125)).shape == (8, 125)


def test_launch_refuses_cpu_tensors(inputs):
    _, _, t = inputs
    plan = _plan(t["packed"].numel(), True, t["src"].numel())
    with pytest.raises(ValueError, match="CUDA tensors"):
        recount.launch(t["packed"], t["src"], plan, packed=True)
