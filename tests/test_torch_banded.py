"""The port's warps against ``tobac_flow_tpu/ops/banded.py`` on the CPU.

Tolerance: none.  Every warp mirrors the reference's displacement clips,
pad rules and order of interpolation terms, and is bit-equal to it (NaN
where the reference has NaN).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from tobac_flow_tpu.ops import banded as jb  # noqa: E402
from tobac_flow_tpu.ops.warp import _cubic_weights as j_cubic_weights  # noqa: E402
from tobac_flow_tpu.ops.warp import shift_plane as j_shift_plane  # noqa: E402
from tobac_flow_tpu_torch.ops import banded as pb  # noqa: E402
from tobac_flow_tpu_torch.ops.warp import _cubic_weights, shift_plane  # noqa: E402

OFFSETS = [(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]


def _bit_equal(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    assert same.all(), f"{(~same).sum()} of {a.size} differ"


def _scene(seed=0, shape=(37, 53), scale=4.0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    img[5:9, 10:14] = np.nan  # NaN sources: only non-zero weights may read them
    flow = rng.normal(0, scale, shape + (2,)).astype(np.float32)
    flow[::7] = np.round(flow[::7])  # exact-integer displacements (zero weights)
    flow[3, :, 0] = 11.0  # beyond the band: clipped
    return img, flow


@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_warp_banded_multi_edge(method):
    img, flow = _scene()
    img = np.nan_to_num(img, nan=3.0)
    stack = np.stack([img, img[::-1].copy(), 2 * img])
    ref = jb.warp_banded_multi(
        jnp.asarray(stack), jnp.asarray(flow), radius=6, method=method, pad_mode="edge"
    )
    out = pb.warp_banded_multi(torch.from_numpy(stack), torch.from_numpy(flow), 6, method)
    _bit_equal(ref, out.numpy())
    # batched: one flow per leading index, broadcast over the channel axis
    out = pb.warp_banded_multi(
        torch.from_numpy(np.stack([stack, stack])),
        torch.from_numpy(np.stack([flow, -flow]))[:, None], 6, method,
    ).numpy()
    _bit_equal(ref, out[0])
    _bit_equal(
        jb.warp_banded_multi(jnp.asarray(stack), jnp.asarray(-flow), radius=6,
                             method=method, pad_mode="edge"),
        out[1],
    )


@pytest.mark.parametrize("radius", [8, 3])
def test_warp_banded_exact(radius):
    img, flow = _scene(seed=1)
    ref = jb.warp_banded_exact(
        jnp.asarray(img), jnp.asarray(flow), method="linear", radius_y=radius,
        radius_x=radius,
    )
    out = pb.warp_banded_exact(torch.from_numpy(img), torch.from_numpy(flow), radius)
    _bit_equal(ref, out.numpy())


@pytest.mark.parametrize("radius", [8, 3])
def test_warp_banded_exact_multi_sobel_offsets(radius):
    img, flow = _scene(seed=2)
    ref = jb.warp_banded_exact_multi(
        jnp.asarray(img), jnp.asarray(flow), OFFSETS, radius, radius, "linear", jnp.nan
    )
    out = pb.warp_banded_exact_multi(torch.from_numpy(img), torch.from_numpy(flow), OFFSETS, radius)
    _bit_equal(ref, out.numpy())
    # batched over frames: each frame warps by its own flow
    frames = np.stack([img, img[:, ::-1].copy()])
    flows = np.stack([flow, -flow])
    out = pb.warp_banded_exact_multi(
        torch.from_numpy(frames), torch.from_numpy(flows), OFFSETS, radius
    ).numpy()
    for i in range(2):
        ref = jb.warp_banded_exact_multi(
            jnp.asarray(frames[i]), jnp.asarray(flows[i]), OFFSETS, radius, radius,
            "linear", jnp.nan,
        )
        _bit_equal(ref, out[:, i])


def test_shift_plane():
    img, _ = _scene(seed=3)
    _bit_equal(
        j_shift_plane(jnp.asarray(img), OFFSETS, fill_value=jnp.nan),
        shift_plane(torch.from_numpy(img), OFFSETS, math.nan).numpy(),
    )


def test_cubic_weights():
    # against the weights as the reference's compiled programs round them
    # (XLA fuses their multiply-adds; eager JAX rounds each step apart)
    f = np.random.default_rng(4).uniform(0, 1, 1000).astype(np.float32)
    ref = jax.jit(lambda f: j_cubic_weights(f))(jnp.asarray(f))
    for ref, out in zip(ref, _cubic_weights(torch.from_numpy(f))):
        _bit_equal(ref, out.numpy())
