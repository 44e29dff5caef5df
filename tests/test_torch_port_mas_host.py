"""The port's host MAS (`jyutvoice_tpu_torch/align/`: `maximum_path_host`
over its copy of `mas.cpp`, and the numpy DP without g++) against the JAX
package's `align.maximum_path`, its numpy DP and the port's own device
wavefront `maximum_path`, on ragged numpy-seeded batches. Every path must
be bit-exact: MAS is an argmax, and the training step holds it exact."""

import concurrent.futures
import ctypes
import logging
import os

import numpy as np
import pytest
import torch

from jyutvoice_tpu import align as jalign
from jyutvoice_tpu_torch import align as palign
from jyutvoice_tpu_torch import kernels
from torch_port_setup import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _case(seed, b, t_x, t_y, full_row=True):
    """Ragged log-priors: text lengths 2..t_x, mel lengths >= text lengths;
    row 0 at the full (t_x, t_y) when full_row."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((b, t_x, t_y)).astype(np.float32)
    t_xs = rng.integers(2, t_x + 1, b)
    t_ys = np.array([rng.integers(tx, t_y + 1) for tx in t_xs])
    if full_row:
        t_xs[0], t_ys[0] = t_x, t_y
    if b > 1:
        t_ys[1] = t_xs[1]  # a row with as many frames as tokens
    mask = np.zeros((b, t_x, t_y), np.float32)
    for i in range(b):
        mask[i, : t_xs[i], : t_ys[i]] = 1
    return value, mask, t_xs.astype(np.int32), t_ys.astype(np.int32)


CASES = [(0, 5, 11, 23), (1, 4, 32, 96), (2, 2, 64, 300), (3, 7, 3, 5)]


@pytest.mark.parametrize("seed,b,t_x,t_y", CASES)
def test_host_mas_matches_jax_and_device(seed, b, t_x, t_y):
    value, mask, t_xs, t_ys = _case(seed, b, t_x, t_y)
    want = jalign.maximum_path(value, mask)
    got = palign.maximum_path_host(value, mask)
    assert got.dtype == np.float32 and got.shape == (b, t_x, t_y)
    np.testing.assert_array_equal(got, want)
    device = palign.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, device)
    # the numpy DPs of both packages, on the masked value (written in place)
    port_np = palign._maximum_path_numpy((value * mask).copy(), t_xs, t_ys)
    jax_np = jalign._maximum_path_numpy((value * mask).copy(), t_xs, t_ys)
    np.testing.assert_array_equal(port_np, jax_np)
    np.testing.assert_array_equal(port_np.astype(np.float32) * mask, want)
    # value is left as given
    assert np.array_equal(value, _case(seed, b, t_x, t_y)[0])


def test_library_builds_into_build_dir():
    lib = palign._get_lib()
    assert lib is not None, "mas.cpp should build with g++"
    path = palign._lib_path()
    assert os.path.dirname(path) == kernels.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libmas-")
    assert not os.path.exists(os.path.join(os.path.dirname(palign.__file__), "libmas.so"))


def test_fallback_without_gxx_is_logged_and_exact(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(palign, "_lib", None)
    monkeypatch.setattr(palign, "_lib_tried", False)
    monkeypatch.setattr(palign, "_GXX", ("no-such-compiler-g++",))
    monkeypatch.setattr(palign, "_lib_path", lambda: str(tmp_path / "libmas-x.so"))
    monkeypatch.setattr(palign, "BUILD_DIR", str(tmp_path))
    value, mask, _, _ = _case(5, 3, 9, 20)
    with caplog.at_level(logging.WARNING, logger=palign.__name__):
        got = palign.maximum_path_host(value, mask)
    assert palign._get_lib() is None
    assert "numpy fallback" in caplog.text
    assert not list(tmp_path.iterdir())  # no half-written library left behind
    np.testing.assert_array_equal(got, jalign.maximum_path(value, mask))


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Processes of a parallel test run may build at once: each compiles to
    a temporary file and renames it into place."""
    target = str(tmp_path / "libmas-test.so")
    monkeypatch.setattr(palign, "_lib_path", lambda: target)
    monkeypatch.setattr(palign, "BUILD_DIR", str(tmp_path))
    real_exists = os.path.exists
    # every thread compiles (none sees another's finished library first)
    monkeypatch.setattr(palign.os.path, "exists",
                        lambda p: False if p == target else real_exists(p))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: palign._build_lib(), range(4)))
    assert paths == [target] * 4
    assert [p.name for p in tmp_path.iterdir()] == ["libmas-test.so"]
    lib = ctypes.CDLL(target)
    assert lib.maximum_path_batch
