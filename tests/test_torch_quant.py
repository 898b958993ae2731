"""repro_torch int8 codec and fused arena kernels against the JAX reference.

The port's plain versions (what its wrappers run for CPU tensors) against
``repro.kernels.quant`` and ``repro.kernels.pack_quant`` on the same numpy
inputs: the reference's oracles (``ref.py``), and its wrappers, which run
the Pallas kernels in interpret mode where they tile and the oracle
elsewhere.  The parametrisations are those of the reference's own kernel
tests, its misaligned shapes included, plus a zero block (with -0.0 in
it) and blocks holding a NaN and an inf.  Tolerances:

* the int8 payload is bitwise, against both;
* scales are bitwise against the oracle and within one ulp (rtol 1.2e-7)
  of the interpret-mode kernel, the reference's own bound between the two;
* residual and decode are bitwise against the oracle, whose scales are the
  port's.  The interpret-mode kernel runs under ``jit``, where XLA's CPU
  fusion contracts ``x - q * scale`` into one FMA, so its residual is held
  to the reference's own kernel-against-oracle tolerance (rtol 1e-5,
  atol 1e-6);
* a NaN or inf block has a NaN or inf scale, all q 0 and a NaN decode and
  residual, as the oracle gives on the CPU (XLA casts NaN to 0).

Also: the fused error feedback (``write_quant`` given ``ef``) against the
reference's unfused composition (``src + ef``, then the write), the port's
``QuantCommArena`` against the reference's on the layout of its arena
test, and the codec and error feedback against the reference's, all
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire_codec import ErrorFeedback as JaxErrorFeedback
from repro.comm.wire_codec import Int8BlockCodec as JaxInt8BlockCodec
from repro.kernels.pack_quant import ops as jax_pq_ops
from repro.kernels.pack_quant import ref as jax_pq_ref
from repro.kernels.quant import ops as jax_q_ops
from repro.kernels.quant import ref as jax_q_ref
from repro.mem.arena import QuantCommArena as JaxQuantCommArena
from repro.mem.layout import plan_quant_arena as jax_plan_quant_arena
from repro_torch.comm.wire_codec import ErrorFeedback, Int8BlockCodec
from repro_torch.kernels.pack_quant import ops as pq_ops
from repro_torch.kernels.pack_quant import ref as pq_ref
from repro_torch.kernels.quant import ops as q_ops
from repro_torch.mem.arena import QuantCommArena
from repro_torch.mem.layout import plan_quant_arena

SCALE_RTOL = 1.2e-7            # one fp32 ulp

QUANT_CASES = [  # (n, block, special): the reference's aligned cases, its
                 # misaligned ones (its oracle) and its zero-block case,
                 # then blocks holding a NaN and an inf
    (4096, 512, None), (2048, 128, None), (8192, 1024, None),
    (512, 256, None), (960, 96, None), (192, 96, None), (640, 320, None),
    (1024, 256, "zero"), (2048, 512, "nonfinite"), (4096, 128, "nonfinite"),
    (384, 96, "nonfinite")]
PACK_CASES = [  # (n, offset, block, payload, total, special)
    (2048, 512, 512, 8192, 8192 + 128, None),
    (4096, 0, 512, 8192, 8192 + 128, None),
    (1024, 2048, 256, 8192, 8192 + 128, None),
    (3072, 1024, 1024, 8192, 8192 + 128, None),
    (1024, 256, 512, 4096, 4096 + 128, None),   # offset not a block multiple
    (960, 0, 96, 4096, 4096 + 128, None),       # block not lane-aligned
    (512, 0, 512, 4096, 4096 + 100, None),      # arena not lane-aligned
    (2048, 2048, 512, 8192, 8192 + 128, "nonfinite"),
    (384, 96, 96, 4096, 4096 + 128, "nonfinite")]


def _x(n, block, seed, special=None):
    """Seeded fp32 values; the first block is zeros, half of them -0.0
    (the reference's tests zero it too), and with ``special`` "nonfinite"
    the second block holds a NaN and the third a -inf."""
    x = (np.random.RandomState(seed).randn(n) * 3.0).astype(np.float32)
    if special == "zero":
        x[:] = 0.0
    x[:block] = 0.0
    x[1:block:2] = -0.0
    if special == "nonfinite":
        x[block + 5] = np.nan
        x[2 * block + 3] = -np.inf
    return x


def _bits(a):
    """fp32 as int32 bits for a bitwise comparison that tells -0.0 from
    0.0; every NaN as one pattern (NaN payloads are not specified)."""
    a = np.array(a, np.float32)
    a[np.isnan(a)] = np.nan
    return a.view(np.int32)


def _bitwise(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _jax_quantize(x, block):
    """The reference wrapper: Pallas (interpret) where it tiles, else its
    oracle."""
    q, s = jax_q_ops.quantize(jnp.asarray(x), block, interpret=True)
    return np.asarray(q), np.asarray(s)


def _oracle_quantize(x, block):
    q, s = jax_q_ref.quantize_blocks(jnp.asarray(x).reshape(-1, block))
    return np.asarray(q).reshape(-1), np.asarray(s).reshape(-1)


def _check_bound(decoded, x, scales, block):
    """Every finite block decodes within half a quantum."""
    bound = np.repeat(scales, block) * 0.5 + 1e-8
    ok = np.isfinite(np.repeat(scales, block))
    assert np.all(np.abs(decoded - x)[ok] <= bound[ok])


@pytest.mark.parametrize("n,block,special", QUANT_CASES)
def test_quantize_matches_reference(n, block, special):
    x = _x(n, block, n + block, special)
    before = dict(q_ops.LAUNCHES)
    q, s = q_ops.quantize(torch.from_numpy(x), block)
    assert q_ops.LAUNCHES == before            # CPU: the plain version
    assert q.dtype == torch.int8 and s.shape == (n // block,)
    oq, os_ = _oracle_quantize(x, block)
    wq, ws = _jax_quantize(x, block)
    np.testing.assert_array_equal(q.numpy(), oq)
    np.testing.assert_array_equal(q.numpy(), wq)
    _bitwise(s.numpy(), os_)
    np.testing.assert_allclose(s.numpy(), ws, rtol=SCALE_RTOL, atol=0)
    back = q_ops.dequantize(q, s, block).numpy()
    _bitwise(back, np.asarray(jax_q_ref.dequantize_blocks(
        jnp.asarray(oq).reshape(-1, block),
        jnp.asarray(os_).reshape(-1, 1))).reshape(-1))
    _check_bound(back, x, s.numpy(), block)
    assert np.all(s.numpy()[0] == np.finfo(np.float32).tiny)
    assert np.all(q.numpy()[:block] == 0) and np.all(back[:block] == 0)
    if special == "nonfinite":
        assert np.isnan(s[1]) and np.isposinf(s[2])
        assert np.all(q.numpy()[block:3 * block] == 0)
        assert np.isnan(back[block:3 * block]).all()


@pytest.mark.parametrize("n,block,special", QUANT_CASES)
def test_dequantize_matches_reference(n, block, special):
    """Decoding the reference's own payload: one multiply, bitwise."""
    x = _x(n, block, 7 * n + block, special)
    wq, ws = _jax_quantize(x, block)
    got = q_ops.dequantize(torch.from_numpy(wq.copy()),
                           torch.from_numpy(ws.copy()), block).numpy()
    _bitwise(got, np.asarray(jax_q_ops.dequantize(
        jnp.asarray(wq), jnp.asarray(ws), block, interpret=True)))
    _bitwise(got, np.asarray(jax_q_ref.dequantize_blocks(
        jnp.asarray(wq).reshape(-1, block),
        jnp.asarray(ws).reshape(-1, 1))).reshape(-1))


def _jax_write(arena, x, offset, payload, block):
    """The reference's oracle, and its wrapper (Pallas in interpret mode
    where it tiles, else that oracle); numpy ``(arena, residual)`` each."""
    args = (jnp.asarray(arena), jnp.asarray(x), offset, payload, block)
    oracle = jax_pq_ref.write_quant_flat(*args)
    wrapper = (oracle if offset % block
               else jax_pq_ops.write_quant_flat(*args, interpret=True))
    return ([np.asarray(a) for a in oracle], [np.asarray(a) for a in wrapper])


@pytest.mark.parametrize("n,offset,block,payload,total,special", PACK_CASES)
def test_write_quant_matches_reference(n, offset, block, payload, total,
                                       special):
    """The fused write with error feedback against the reference's pack,
    which adds the accumulator and then writes: payload, scale bytes and
    residual bitwise against its oracle, and with its Pallas kernel's
    tolerances against that kernel; no other byte of the arena moves."""
    rng = np.random.RandomState(n + offset + block)
    x = _x(n, block, n + offset, special)
    ef0 = (rng.randn(n) * 0.05).astype(np.float32)
    arena = rng.randint(-128, 128, total).astype(np.int8)   # stale bytes
    comp = np.asarray(jnp.asarray(x) + jnp.asarray(ef0))    # the pack's add
    (want, wres), (kern, kres) = _jax_write(arena, comp, offset, payload,
                                            block)
    got = torch.from_numpy(arena.copy())
    ptr = got.data_ptr()
    ef = torch.from_numpy(ef0.copy())
    if offset % block:
        # the layout never places a segment off a block boundary: the
        # wrapper refuses it, its plain version computes the oracle's bytes
        with pytest.raises(ValueError, match="multiple of block"):
            pq_ops.write_quant_flat(got, torch.from_numpy(x), offset,
                                    payload, block, ef)
        out = pq_ref.write_quant_flat(got, torch.from_numpy(x), offset,
                                      payload, block, ef)
    else:
        before = dict(pq_ops.LAUNCHES)
        out = pq_ops.write_quant_flat(got, torch.from_numpy(x), offset,
                                      payload, block, ef)
        assert pq_ops.LAUNCHES == before
    assert out.data_ptr() == ptr and ef.data_ptr() == ef.data_ptr()
    got = out.numpy()
    lo = pq_ref.scale_byte_offset(payload, offset, block)
    hi = pq_ref.scale_byte_offset(payload, offset + n, block)
    np.testing.assert_array_equal(got[offset:offset + n],
                                  want[offset:offset + n])
    np.testing.assert_array_equal(got[offset:offset + n],
                                  kern[offset:offset + n])
    mask = np.ones(total, bool)
    mask[offset:offset + n] = mask[lo:hi] = False
    np.testing.assert_array_equal(got[mask], arena[mask])   # nothing else
    scales = got[lo:hi].view(np.float32)
    _bitwise(scales, want[lo:hi].view(np.float32))
    np.testing.assert_allclose(scales, kern[lo:hi].view(np.float32),
                               rtol=SCALE_RTOL, atol=0)
    _bitwise(ef.numpy(), wres)
    np.testing.assert_allclose(ef.numpy(), kres, rtol=1e-5, atol=1e-6)
    decoded = pq_ref.read_dequant_flat(out, offset, n, payload, block)
    _check_bound(decoded.numpy(), comp, scales, block)
    if special == "nonfinite":
        assert np.isnan(ef.numpy()[block:3 * block]).all()


@pytest.mark.parametrize("n,offset,block,payload,total,special", PACK_CASES)
def test_read_dequant_matches_reference(n, offset, block, payload, total,
                                        special):
    """Decoding the reference's own arena bytes: one multiply, bitwise."""
    x = _x(n, block, 3 * n + offset, special)
    arena = _jax_write(np.zeros((total,), np.int8), x, offset, payload,
                       block)[1][0].copy()
    if offset % block:
        want = jax_pq_ref.read_dequant_flat(jnp.asarray(arena), offset, n,
                                            payload, block)
        with pytest.raises(ValueError, match="multiple of block"):
            pq_ops.read_dequant_flat(torch.from_numpy(arena), offset, n,
                                     payload, block)
        got = pq_ref.read_dequant_flat(torch.from_numpy(arena), offset, n,
                                       payload, block)
    else:
        want = jax_pq_ops.read_dequant_flat(jnp.asarray(arena), offset, n,
                                            payload, block, interpret=True)
        got = pq_ops.read_dequant_flat(torch.from_numpy(arena), offset, n,
                                       payload, block)
    _bitwise(got.numpy(), np.asarray(want))
    _bitwise(got.numpy(), np.asarray(jax_pq_ref.read_dequant_flat(
        jnp.asarray(arena), offset, n, payload, block)))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_quant_arena_matches_reference(impl):
    """The reference's arena test layout (two segments fused in one span):
    payload and scale bytes after a pack with error feedback, the new
    accumulator, the unpacked buffers, a span's decode and its re-encode,
    all bitwise."""
    lay = plan_quant_arena([4096, 8192], page_bytes=4096, block=512,
                           channel_of=[0, 0])
    jlay = jax_plan_quant_arena([4096, 8192], page_bytes=4096, block=512,
                                channel_of=[0, 0])
    assert lay.describe() == jlay.describe()
    rng = np.random.RandomState(5)
    bufs = [(rng.randn(s.size) * 3.0).astype(np.float32)
            for s in sorted(lay.segments, key=lambda s: s.bucket)]
    ef0 = (rng.randn(lay.payload_elems) * 0.05).astype(np.float32)
    arena, jarena = QuantCommArena(lay, impl), JaxQuantCommArena(jlay, "jnp")
    buf, ef = arena.zeros("cpu"), torch.from_numpy(ef0.copy())
    ptrs = (buf.data_ptr(), ef.data_ptr())
    out, ef_out = arena.pack_into(buf, [torch.from_numpy(b) for b in bufs],
                                  ef)
    assert (out.data_ptr(), ef_out.data_ptr()) == ptrs        # in place
    jout, jef = jarena.pack_into(jarena.zeros(),
                                 [jnp.asarray(b) for b in bufs],
                                 jnp.asarray(ef0))
    jout, jef = np.asarray(jout), np.asarray(jef)
    np.testing.assert_array_equal(out.numpy(), jout)  # payload and scales
    _bitwise(ef_out.numpy(), jef)
    for b, u, ju in zip(bufs, arena.unpack(out), jarena.unpack(jout)):
        _bitwise(u.numpy(), np.asarray(ju))
        assert np.abs(u.numpy() - b).max() < np.abs(b).max() / 127 + 0.2
    span = arena.dequant_span(out, 0)
    _bitwise(span.numpy(), np.asarray(jarena.dequant_span(jout, 0)))
    vals = (rng.randn(lay.spans[0].size) * 2.0).astype(np.float32)
    arena.requant_span(out, 0, torch.from_numpy(vals))
    jre = np.asarray(jarena.requant_span(jout, 0, jnp.asarray(vals)))
    np.testing.assert_array_equal(out.numpy(), jre)
    # fp32 spans (the all-gathered deltas of ZeRO) slice out without codec
    for u, ju in zip(arena.unpack_spans([torch.from_numpy(vals)]),
                     jarena.unpack_spans([jnp.asarray(vals)])):
        _bitwise(u.numpy(), np.asarray(ju))


@pytest.mark.parametrize("block", [128, 512])
def test_codec_and_error_feedback_match_reference(block):
    """The one flat payload unpacks to the reference's ``q`` and ``scale``
    bitwise; decode, compensation and residual are bitwise too."""
    rng = np.random.RandomState(block)
    buckets = [(rng.randn(4 * block) * 2.0).astype(np.float32)
               for _ in range(3)]
    res = [(rng.randn(4 * block) * 0.01).astype(np.float32) for _ in range(3)]
    codec, jcodec = Int8BlockCodec(block, impl="kernel"), \
        JaxInt8BlockCodec(block)
    assert codec.wire_bytes(4096) == jcodec.wire_bytes(4096)
    # one flat int8 payload: the reference's scales' bytes, then its values
    payload = codec.encode(torch.from_numpy(buckets[0]))
    jpayload = jcodec.encode(jnp.asarray(buckets[0]))
    assert payload.dtype == torch.int8
    assert payload.shape == (codec.wire_bytes(4 * block),)
    q, scale = codec.split(payload)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jpayload["q"]))
    _bitwise(scale.numpy(), np.asarray(jpayload["scale"]))
    np.testing.assert_array_equal(payload[16:].numpy(),
                                  np.asarray(jpayload["q"]))
    np.testing.assert_array_equal(
        payload[:16].numpy(),
        np.asarray(jpayload["scale"]).view(np.int8))
    _bitwise(codec.decode(payload).numpy(),
             np.asarray(jcodec.decode(jpayload)))
    comp, new = ErrorFeedback(codec).compensate(
        [torch.from_numpy(b) for b in buckets],
        [torch.from_numpy(r) for r in res])
    jcomp, jnew = JaxErrorFeedback(jcodec).compensate(
        [jnp.asarray(b) for b in buckets], [jnp.asarray(r) for r in res])
    for c, jc, n, jn in zip(comp, jcomp, new, jnew):
        _bitwise(c.numpy(), np.asarray(jc))
        _bitwise(n.numpy(), np.asarray(jn))
        # the residual is exactly what the codec cannot carry
        _bitwise(n.numpy(), (c - codec.decode(codec.encode(c))).numpy())
