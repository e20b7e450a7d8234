"""PyTorch port, ops: plain versions against the JAX functions on the CPU.

The Pallas kernels run in interpret mode (MDV2_PALLAS_INTERPRET=1, set by
tests/conftest.py); the port runs its plain versions, which is what its wrappers
use for a CPU tensor. fp32 throughout; tolerances as in the JAX package's own
kernel tests (atol 2e-5 / rtol 1e-4: two fp32 evaluation orders of the same
softmax).
"""
import numpy as np
import pytest
import torch

from test_torch_common import all_threads, j, t

import jax

from magicdrive_v2_tpu.ops import flash_fused
from magicdrive_v2_tpu.ops import rope as jrope
from magicdrive_v2_tpu.ops.attention import xla_attention
from magicdrive_v2_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from magicdrive_v2_tpu.ops.fused_adaln import _xla_fallback, adaln_modulate as jax_adaln
from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                         apply_rope, dot_product_attention,
                                         flash_attention, flash_attention_plain,
                                         fused_qkv_attention, fused_qkv_attention_plain,
                                         plain_attention, rope_frequencies,
                                         rotate_half_interleaved)
from magicdrive_v2_tpu_torch.ops.flash_attention import PADDED_WIDTH as K3_WIDTH
from magicdrive_v2_tpu_torch.ops.flash_attention import plan_bf16 as k3_plan
from magicdrive_v2_tpu_torch.ops.flash_fused import PADDED_WIDTH, SMEM_LIMIT, plan_bf16

G, N, H, D = 4, 40, 2, 8
ATOL, RTOL = 2e-5, 1e-4
# torch's own thread count here: the bit-equality of the plain versions over group
# chunkings (``test_chip_smoke_bf16_limits_reject_a_dropped_k_norm_weight``) holds
# for the CPU GEMM's blocking at that count, not at the tests' cap of 2
_all_threads = pytest.fixture(all_threads, autouse=True, scope="module")


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- rope


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    _close(rope_frequencies(16, 7), jrope.rope_frequencies(16, 7), 1e-6, 1e-6)
    _close(rotate_half_interleaved(t(x)), jrope.rotate_half_interleaved(j(x)), 0, 0)
    _close(apply_rope(t(x)), jrope.apply_rope(j(x)), 1e-6, 1e-6)
    # interleaved pairs, not the half-split rotation
    r = rotate_half_interleaved(torch.arange(4.0)[None])
    assert r.tolist() == [[-1.0, 0.0, -3.0, 2.0]]


# ---------------------------------------------------------------- plain attention


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_attention_matches_xla_attention(with_bias):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    bias = None
    if with_bias:
        keep = rng.integers(0, 2, (2, 5)).astype(bool)
        keep[:, 0] = True
        bias = np.where(keep[:, None, None, :], 0.0, -1e9).astype(np.float32)
    ref = xla_attention(j(q), j(k), j(v), bias=None if bias is None else j(bias))
    out = dot_product_attention(t(q), t(k), t(v), bias=None if bias is None else t(bias))
    _close(out, ref, 1e-6, 1e-5)
    _close(plain_attention(t(q), t(k), t(v), bias=None if bias is None else t(bias)),
           ref, 1e-6, 1e-5)


def test_dispatcher_sends_unbiased_cpu_calls_through_flash_wrapper():
    rng = np.random.default_rng(2)
    q, k, v = (t(rng.standard_normal((1, 6, 2, 8)).astype(np.float32)) for _ in range(3))
    before = flash_attention.launches
    out = dot_product_attention(q, k, v)
    # a CPU tensor takes the plain version and does not count as a kernel launch
    assert flash_attention.launches == before
    _close(out, flash_attention_plain(q, k, v).numpy(), 0, 0)


# ---------------------------------------------------------------- K1 fused qkv attention


@pytest.fixture(scope="module")
def qkv_data():
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((G, N, 3, H, D)).astype(np.float32)
    qw = (rng.standard_normal((D,)) * 0.1 + 1.0).astype(np.float32)
    kw = (rng.standard_normal((D,)) * 0.1 + 1.0).astype(np.float32)
    return qkv, qw, kw


def _perms():
    roll = np.roll(np.arange(G), 1).astype(np.int32)
    two = np.stack([roll, np.roll(np.arange(G), -1)]).astype(np.int32)
    return {"none": None, "1d": roll, "2d": two}


def _jax_bodies(qkv, qw, kw, perm, norm):
    """All three Pallas bodies (interpret mode) and the XLA reference."""
    scale = D ** -0.5
    perm_t = None if perm is None else (
        tuple(perm.tolist()) if perm.ndim == 1 else tuple(tuple(p) for p in perm.tolist()))
    a, b = (j(qw), j(kw)) if norm else (None, None)
    return {
        # block_q 16 / 32: even and uneven (40 = 32 + 8) q blocks
        "full_row_bq16": flash_fused._fused_fwd_impl(j(qkv), a, b, perm_t, scale, 16, norm),
        "full_row_bq32": flash_fused._fused_fwd_impl(j(qkv), a, b, perm_t, scale, 32, norm),
        # block_k 16 leaves a ragged trailing k block (40 = 2*16 + 8)
        "blocked": flash_fused._fused_fwd_blocked(j(qkv), a, b, perm_t, scale, 16, 16, norm),
        "blocked_hsplit": flash_fused._fused_fwd_blocked_hsplit(
            j(qkv), a, b, perm_t, scale, 32, 16, norm),
        "xla_reference": flash_fused._xla_reference(j(qkv), a, b, perm, scale),
    }


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("perm_kind", ["none", "1d", "2d"])
def test_fused_qkv_plain_matches_pallas_bodies(qkv_data, perm_kind, norm):
    qkv, qw, kw = qkv_data
    perm = _perms()[perm_kind]
    out = fused_qkv_attention_plain(t(qkv), t(qw) if norm else None,
                                    t(kw) if norm else None, perm)
    assert out.shape == (G, N, H, D)
    for name, ref in _jax_bodies(qkv, qw, kw, perm, norm).items():
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_fused_qkv_wrapper_on_cpu_is_plain_and_chunking_is_exact(qkv_data):
    qkv, qw, kw = qkv_data
    perm = _perms()["2d"]
    before = fused_qkv_attention.launches
    a = fused_qkv_attention(t(qkv), t(qw), t(kw), perm)
    b = fused_qkv_attention_plain(t(qkv), t(qw), t(kw), torch.from_numpy(perm),
                                  group_chunk=3)
    assert fused_qkv_attention.launches == before
    _close(a, b.numpy(), 1e-6, 1e-6)


def test_fused_qkv_wrapper_rejects_bad_arguments(qkv_data):
    qkv, qw, kw = qkv_data
    with pytest.raises(ValueError):
        fused_qkv_attention(t(qkv)[:, :, :2], None, None)
    with pytest.raises(ValueError):
        fused_qkv_attention(t(qkv), t(qw), None)
    with pytest.raises(ValueError):
        fused_qkv_attention(t(qkv), None, None, [0, 1, 2, G])


def test_fused_qkv_plain_bf16_follows_kernel_cast_points():
    """In bf16 the normalised q/k are rounded before the weight multiply (the
    Pallas ``_rms_kernel`` cast points); the XLA reference skips that rounding, so
    the plain version is compared with the Pallas body, not with the reference."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((2, 24, 3, 2, 8)).astype(np.float32)
    qw = (rng.standard_normal((8,)) * 0.1 + 1.0).astype(np.float32)
    import jax.numpy as jnp
    ref = flash_fused._fused_fwd_impl(j(qkv).astype(jnp.bfloat16), j(qw), j(qw), None,
                                      8 ** -0.5, 24, True)
    out = fused_qkv_attention_plain(t(qkv).bfloat16(), t(qw), t(qw))
    # one bf16 ulp at |x| < 2 is 2**-7; evaluation order may flip the last bit
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2 ** -6, rtol=0)


def test_cross_view_yardstick_is_two_single_source_attentions(qkv_data):
    """chip_smoke.py times two scaled_dot_product_attention calls, one per source,
    summed, beside K1 with J=2 and no norm: the same function."""
    qkv, _, _ = qkv_data
    perm = _perms()["2d"]
    x = t(qkv)
    both = fused_qkv_attention_plain(x, None, None, perm)
    sources = [torch.from_numpy(p).long() for p in perm]
    single = sum(fused_qkv_attention_plain(torch.cat([x[:, :, :1], x[idx][:, :, 1:]], dim=2),
                                           None, None) for idx in sources)
    _close(both, single.numpy(), 1e-6, 1e-6)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    sdpa = sum(torch.nn.functional.scaled_dot_product_attention(q, k[idx], v[idx])
               for idx in sources)
    _close(both, sdpa.transpose(1, 2).numpy())


# ---------------------------------------------------------------- K1 bf16 launch plan


def test_k1_plan_at_the_main_path_shape():
    plan = plan_bf16(60, 1350, 16, 72)
    # head dim 72 padded to 80 (five 16-deep k-steps); 1350 rows = 10 x 128 + 70
    assert (plan.dp, plan.q_tiles, plan.tiles) == (80, 11, 22)
    assert plan.blocks == 60 * 16 * 11
    assert plan.scratch_shape == (60, 16, 22, 10, 64, 8)  # normalised k
    # two q tiles, three k and three v tiles of 64 x 80 bf16
    assert plan.smem_bytes == 2 * (2 + 2 * 3) * 64 * 80
    # cross-view: a two-stage ring and the fp32 sum over sources, 36 floats a thread
    cross = plan_bf16(60, 1350, 16, 72, J=2)
    assert cross._replace(smem_bytes=0) == plan._replace(smem_bytes=0)
    assert cross.smem_bytes == 2 * (2 + 2 * 2) * 64 * 80 + 4 * 36 * 256


@pytest.mark.parametrize("D", sorted(PADDED_WIDTH))
def test_k1_plan_shared_memory_fits_one_block(D):
    """Every head dim the bf16 body takes: the padded width covers it in 16-deep
    k-steps, the tiles cover the rows, and the block's shared memory stays under
    the card's per-block limit, twice over (two blocks on one SM)."""
    for N in (1, 64, 70, 130, 1350, 5300):
        for J in (1, 2, 3):
            plan = plan_bf16(3, N, 2, D, J)
            assert plan.dp >= D and plan.dp % 16 == 0
            assert plan.q_tiles * 128 >= N > (plan.q_tiles - 1) * 128
            assert plan.tiles * 64 >= N
            assert 2 * plan.smem_bytes < SMEM_LIMIT


@pytest.mark.parametrize("D", [12, 40, 64, 144])
def test_k1_plan_refuses_a_head_dim_the_bf16_body_does_not_take(D):
    with pytest.raises(ValueError):
        plan_bf16(2, 100, 2, D)


# ---------------------------------------------------------------- K2 adaLN modulate


@pytest.mark.parametrize("C", [128, 64], ids=["C128_pallas_interpret", "C64_fallback"])
def test_adaln_plain_matches_jax(C):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, C)).astype(np.float32) * 3 + 0.5
    shift = rng.standard_normal((2, C)).astype(np.float32)
    scale = rng.standard_normal((2, C)).astype(np.float32)
    ref = jax_adaln(j(x), j(shift), j(scale))  # C % 128 == 0 -> Pallas, else XLA fallback
    before = adaln_modulate.launches
    out = adaln_modulate(t(x), t(shift), t(scale)[:, None])
    assert adaln_modulate.launches == before
    # fp32 statistics in two orders of summation over C <= 128 values
    _close(out, ref, 1e-5, 1e-5)
    _close(adaln_modulate_plain(t(x), t(shift), t(scale)),
           _xla_fallback(j(x), j(shift)[:, None], j(scale)[:, None], 1e-6), 1e-5, 1e-5)
    with pytest.raises(ValueError):
        adaln_modulate(t(x), t(shift)[:1], t(scale))


# ---------------------------------------------------------------- K3 flash attention


def test_flash_attention_plain_matches_pallas_with_ragged_keys():
    """M != N and a key length that is no multiple of the Pallas block (masked)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 150, 2, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 77, 2, 2, 8)).astype(np.float32)
    ref = jax_flash_attention(j(q), j(kv[:, :, 0]), j(kv[:, :, 1]), None, 128, 128)
    # strided views of a packed kv buffer, as CrossAttention hands them over
    out = flash_attention(t(q), t(kv)[:, :, 0], t(kv)[:, :, 1])
    _close(out, ref)
    _close(flash_attention_plain(t(q), t(kv)[:, :, 0], t(kv)[:, :, 1]),
           xla_attention(j(q), j(kv[:, :, 0]), j(kv[:, :, 1])))
    with pytest.raises(ValueError):
        flash_attention(t(q), t(kv)[:, :5, 0], t(kv)[:, :, 1])


# ---------------------------------------------------------------- K3 bf16 launch plan


def test_k3_plan_at_the_main_path_shape():
    plan = k3_plan(60, 1350, 312, 16, 72)
    # logit depth 80 (five 16-deep k-steps, the last on a zero chunk), value width
    # 72; 312 keys = 4 x 64 + 56, 1350 rows = 10 x 128 + 70
    assert (plan.dp, plan.dv, plan.kv_tiles, plan.q_tiles) == (80, 72, 5, 11)
    # the whole k/v sequence stays in shared memory; 11 q tiles in runs of 6 and 5
    assert plan.resident and plan.run == 6 and plan.blocks == 60 * 16 * 2
    # two q halves of 64 x 72, five k and five v tiles of 64 x 72, the zero chunk
    assert plan.smem_bytes == 2 * (2 * 64 * 72 + 5 * 2 * 64 * 72) + 1024 == 111_616
    # two blocks an SM, each with the runtime's reserved kilobyte
    assert plan.blocks_per_sm == 2 and 2 * (plan.smem_bytes + 1024) <= 233_472
    # the settings chip_smoke.py times: blocks per (batch, head) = ceil(11 / run)
    for run, per_pair in ((1, 11), (2, 6), (3, 4), (4, 3), (6, 2), (11, 1)):
        assert k3_plan(60, 1350, 312, 16, 72, run=run)._replace(run=6, blocks=0) \
            == plan._replace(blocks=0)
        assert k3_plan(60, 1350, 312, 16, 72, run=run).blocks == 60 * 16 * per_pair
    # encode_conditions: head dim 144, 17 rows and keys, one block an SM
    enc = k3_plan(120, 17, 17, 8, 144)
    assert (enc.dp, enc.dv, enc.resident, enc.run, enc.blocks, enc.blocks_per_sm) == \
        (144, 144, True, 1, 120 * 8, 1)


@pytest.mark.parametrize("M", [13, 17, 77, 200, 312, 1350, 4096])
@pytest.mark.parametrize("D", sorted(K3_WIDTH))
def test_k3_plan_tiles_cover_the_rows_and_fit_shared_memory(D, M):
    """Every head dim the bf16 body takes: the logit depth covers it in 16-deep
    k-steps, the tiles cover q rows and keys, every q tile belongs to one block's
    run, and the block's shared memory stays under the card's per-block limit,
    twice over where the plan counts on two blocks an SM. The resident kernel
    takes k/v up to 320 keys at head dim 72; longer ones stream, one q tile a
    block, in the same bytes at every M."""
    for N in (1, 17, 70, 600, 1350):
        plan = k3_plan(3, N, M, 2, D)
        assert plan.dp >= D and plan.dp % 16 == 0 and plan.dv >= D and plan.dv % 8 == 0
        assert plan.q_tiles * 128 >= N > (plan.q_tiles - 1) * 128
        assert plan.kv_tiles * 64 >= M > (plan.kv_tiles - 1) * 64
        runs = -(-plan.q_tiles // plan.run)
        assert plan.blocks == 3 * 2 * runs and (runs - 1) * plan.run < plan.q_tiles
        assert plan.smem_bytes < SMEM_LIMIT
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233_472
        if plan.blocks_per_sm == 2:
            assert 2 * plan.smem_bytes < SMEM_LIMIT
        if not plan.resident:
            assert plan.run == 1 and plan.smem_bytes == k3_plan(3, N, 8192, 2, D).smem_bytes
    if D == 72:
        assert k3_plan(3, 100, M, 2, D).resident == (M <= 320)


@pytest.mark.parametrize("D", [12, 24, 32, 64, 80, 128])
def test_k3_plan_refuses_a_head_dim_the_bf16_body_does_not_take(D):
    with pytest.raises(ValueError):
        k3_plan(2, 100, 50, 2, D)


def test_chip_smoke_k3_cases_reach_both_kernels_and_a_short_run():
    """The extra K3 shapes chip_smoke.py holds against the plain version stream
    k/v at every head dim of the table and leave the last run of a resident
    block short."""
    import chip_smoke
    plans = [k3_plan(*shape) for shape in chip_smoke.K3_BRANCH_CASES]
    streamed = {shape[4] for shape, plan in zip(chip_smoke.K3_BRANCH_CASES, plans)
                if not plan.resident}
    assert streamed == set(K3_WIDTH)
    assert any(plan.resident and plan.q_tiles % plan.run for plan in plans)


def test_k3_plan_refuses_a_run_for_streamed_kv():
    assert k3_plan(2, 300, 2000, 4, 72, run=1).run == 1
    with pytest.raises(ValueError):
        k3_plan(2, 300, 2000, 4, 72, run=2)


@pytest.mark.parametrize("N,H,cross_view", [(1350, 2, False), (5300, 1, False),
                                             (1350, 1, True)],
                         ids=["1350-2", "5300-1", "1350-1-cross_view"])
def test_chip_smoke_bf16_limits_reject_a_dropped_k_norm_weight(N, H, cross_view):
    """The limits chip_smoke.py holds the bf16 kernels to on the card, tried here on
    a stand-in for a faulty kernel: the plain version with the k-norm weight
    replaced by ones. Both limits must refuse it and accept the plain version
    computed in another group chunking (bit-equal). The fault's largest error,
    about 0.02-0.03, is of the size of one typical output value, so a limit that
    is not scaled to the outputs can miss it. Cross-view: six views, each reading
    k/v from its two neighbours (J=2), outputs summed over the two sources."""
    import chip_smoke
    gen = torch.Generator().manual_seed(0)
    D = 72
    G, perm = (6, chip_smoke.cross_view_perm(1)) if cross_view else (2, None)
    qkv = torch.randn(G, N, 3, H, D, generator=gen).bfloat16()
    qw = torch.randn(D, generator=gen) * 0.1 + 1
    kw = torch.randn(D, generator=gen) * 0.1 + 1
    ref = fused_qkv_attention_plain(qkv, qw, kw, perm)
    with_abs_v = qkv.clone()
    with_abs_v[:, :, 2].abs_()
    slack = 2.0 ** -7 * fused_qkv_attention_plain(with_abs_v, qw, kw, perm).float()
    faulty = fused_qkv_attention_plain(qkv, qw, torch.ones(D), perm)
    err, elem_ratio, rms_ratio, _ = chip_smoke.compare(torch, faulty, ref, slack)
    assert elem_ratio > 1.5 and rms_ratio > 4.0, (err, elem_ratio, rms_ratio)
    same = fused_qkv_attention_plain(qkv, qw, kw, perm, group_chunk=1)
    assert chip_smoke.compare(torch, same, ref, slack)[:3] == (0.0, 0.0, 0.0)


# ---------------------------------------------------------------- autograd Functions
#
# On the card each wrapper goes through PlainVJPFunction when autograd records;
# the Function's forward is the kernel, its backward the plain version's,
# recomputed. Here the plain version is handed in as the forward: the backward code
# runs on the CPU and is held against autograd straight through the plain version
# (the same arithmetic: equal to the last bit) and against jax.vjp of the JAX
# function (its custom_vjp backward, Pallas forward in interpret mode).

from magicdrive_v2_tpu_torch.ops.plain_vjp import PlainVJPFunction, backward_calls, needs_grad

GRAD_ATOL = 2e-5  # fp32 grads of the two packages: summation order only


def _leaf(x):
    return t(x).requires_grad_()


def _check_function(out, plain_out, inputs, g, name):
    assert type(out.grad_fn).__name__ == "PlainVJPFunctionBackward"
    torch.testing.assert_close(out, plain_out, rtol=0, atol=0)
    calls = backward_calls.get(name, 0)
    got = torch.autograd.grad(out, inputs, g)
    assert backward_calls[name] == calls + 1
    want = torch.autograd.grad(plain_out, inputs, g)
    for a, b in zip(got, want):
        assert a is not None and bool((a != 0).any())
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("perm_kind", ["none", "2d"], ids=["J1", "J2"])
def test_fused_qkv_function_backward(qkv_data, perm_kind, norm):
    """Grads of qkv and of both norm weights; with J=2 the k/v grads of a group
    sum over the two groups that read it."""
    qkv, qw, kw = qkv_data
    perm = _perms()[perm_kind]
    scale = D ** -0.5
    tq, tw_q, tw_k = _leaf(qkv), _leaf(qw) if norm else None, _leaf(kw) if norm else None
    inputs = [tq] + ([tw_q, tw_k] if norm else [])
    out = PlainVJPFunction.apply(fused_qkv_attention_plain, fused_qkv_attention_plain,
                                 "fused_qkv_attention", tq, tw_q, tw_k, perm, scale)
    g = np.random.default_rng(7).standard_normal(out.shape).astype(np.float32)
    got = _check_function(out, fused_qkv_attention_plain(tq, tw_q, tw_k, perm, scale),
                          inputs, t(g), "fused_qkv_attention")
    perm_t = None if perm is None else tuple(tuple(p) for p in perm.tolist())
    args = (j(qkv), j(qw), j(kw)) if norm else (j(qkv),)
    _, vjp = jax.vjp(lambda *a: flash_fused.fused_qkv_attention(
        *(a if norm else a + (None, None)), perm_t, scale), *args)
    for a, b in zip(got, vjp(j(g))):
        _close(a, b, GRAD_ATOL, RTOL)


def test_adaln_function_backward():
    """Grads of x, shift and scale against autograd through the plain version and
    against jax.vjp of the composition the JAX trainer differentiates."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32) * 3 + 0.5
    sh, sc = (rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    inputs = [_leaf(x), _leaf(sh), _leaf(sc)]
    out = PlainVJPFunction.apply(adaln_modulate_plain, adaln_modulate_plain,
                                 "adaln_modulate", *inputs, 1e-6)
    got = _check_function(out, adaln_modulate_plain(*inputs), inputs, t(g),
                          "adaln_modulate")
    _, vjp = jax.vjp(lambda a, b, c: _xla_fallback(a, b[:, None], c[:, None], 1e-6),
                     j(x), j(sh), j(sc))
    for a, b in zip(got, vjp(j(g))):
        _close(a, b, 1e-4, 1e-5)


@pytest.mark.parametrize("D_", [8, 16], ids=["D8", "D16"])
def test_flash_attention_function_backward_on_strided_kv(D_):
    """k and v are strided views of one (B, M, 2, H, D) projection: their grads land
    on that one tensor, through the views."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 40, 2, D_)).astype(np.float32)
    kv = rng.standard_normal((2, 13, 2, 2, D_)).astype(np.float32)
    tq, tkv = _leaf(q), _leaf(kv)
    scale = D_ ** -0.5
    out = PlainVJPFunction.apply(flash_attention_plain, flash_attention_plain,
                                 "flash_attention", tq, tkv[:, :, 0], tkv[:, :, 1], scale)
    g = rng.standard_normal(out.shape).astype(np.float32)
    got = _check_function(out, flash_attention_plain(tq, tkv[:, :, 0], tkv[:, :, 1]),
                          [tq, tkv], t(g), "flash_attention")
    _, vjp = jax.vjp(lambda a, b: jax_flash_attention(a, b[:, :, 0], b[:, :, 1], None,
                                                      128, 128), j(q), j(kv))
    for a, b in zip(got, vjp(j(g))):
        _close(a, b, GRAD_ATOL, RTOL)


def test_functions_run_only_where_autograd_records():
    x = torch.ones(2, requires_grad=True)
    assert needs_grad(None, x) and not needs_grad(x.detach(), None)
    with torch.no_grad():
        assert not needs_grad(x)
    # the plain path on the CPU stays differentiable, with no Function node
    qkv = torch.randn(2, 5, 3, 1, 8, requires_grad=True)
    out = fused_qkv_attention(qkv, None, None)
    assert "PlainVJPFunction" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert qkv.grad is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_launch_runs_under_the_device_guard(monkeypatch, dtype):
    """Each wrapper's launch (K1's pre-pass and attention, K2, K3), in bf16 and fp32,
    calls its C entry only inside ``_cuda_build.on_device`` of its own input, with
    the stream that guard yields: on a host with several cards rank k launches on
    card k. The C entries are replaced by recorders and the launches driven on CPU
    tensors (the guard is replaced too: this build has no CUDA)."""
    import contextlib
    import importlib

    from magicdrive_v2_tpu_torch.ops import _cuda_build
    k1, k2, k3 = (importlib.import_module(f"magicdrive_v2_tpu_torch.ops.{m}")
                  for m in ("flash_fused", "fused_adaln", "flash_attention"))
    guarded, calls = [], []

    @contextlib.contextmanager
    def guard(tensor):
        guarded.append(tensor)
        try:
            yield 1234
        finally:
            guarded.pop()

    def entry(name):
        def call(*args):
            assert guarded, f"{name} launched outside the device guard"
            assert args[0] == guarded[-1].data_ptr() and args[-1] == 1234, name
            calls.append(name)
            return 0
        return call

    monkeypatch.setattr(_cuda_build, "on_device", guard)
    monkeypatch.setattr(k1, "_fns", (entry("k1 pre-pass"), entry("k1"), entry("k1 fp32")))
    monkeypatch.setattr(k2, "_fn", entry("k2"))
    monkeypatch.setattr(k3, "_fns", (entry("k3"), entry("k3 fp32")))
    for fn in (k1.fused_qkv_attention, k2.adaln_modulate, k3.flash_attention):
        monkeypatch.setattr(fn, "launches", 0)
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 70, 3, 2, 72), np.float32)).to(dtype)
    w = torch.ones(72)
    k1._launch(qkv, w, w, None, 72 ** -0.5)
    x = torch.from_numpy(rng.standard_normal((2, 10, 64), np.float32)).to(dtype)
    k2._launch(x, x[:, 0], x[:, 1], 1e-6)
    q = torch.from_numpy(rng.standard_normal((2, 70, 2, 72), np.float32)).to(dtype)
    k3._launch(q, q[:, :20], q[:, 20:40], 72 ** -0.5)
    bf16 = dtype == torch.bfloat16
    assert calls == (["k1 pre-pass", "k1", "k2", "k3"] if bf16 else ["k1 fp32", "k2", "k3 fp32"])
    assert (k1.fused_qkv_attention.launches, k2.adaln_modulate.launches,
            k3.flash_attention.launches) == (1, 1, 1)
