"""The port's sliding-window helpers and ``sliding_window_inference`` against
the JAX package's on the same volumes, with the same patch model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_pipeline_tpu.ops import sliding_window as jsw
from segmentation_pipeline_torch.ops import sliding_window as tsw

torch.set_num_threads(2)

WEIGHTS = np.random.default_rng(7).normal(size=(2, 3)).astype(np.float32)


def _jax_model(patches):
    return jnp.tanh(patches @ jnp.asarray(WEIGHTS))


def _port_model(patches):
    return torch.tanh(patches @ torch.from_numpy(WEIGHTS))


@pytest.mark.parametrize("spatial,patch,overlap", [
    ((12, 10, 9), (6, 6, 6), (2, 3, 3)), ((16, 16, 16), (8, 8, 8), (0, 0, 0)),
    ((20, 7, 9), (7, 7, 4), (3, 0, 1)), ((9, 9, 9), (9, 9, 9), (4, 4, 4))])
def test_grid_and_window_helpers_match_jax(spatial, patch, overlap):
    locations = tsw.grid_locations(spatial, patch, overlap)
    np.testing.assert_array_equal(locations, jsw.grid_locations(spatial, patch, overlap))
    assert locations.dtype == np.int32
    np.testing.assert_array_equal(tsw.hann_window(patch), jsw.hann_window(patch))


@pytest.mark.parametrize("spatial,patch,overlap,message", [
    ((8, 8, 8), (9, 4, 4), (0, 0, 0), "exceeds"), ((8, 8, 8), (4, 4, 4), (4, 0, 0), "smaller")])
def test_grid_rejects_what_jax_rejects(spatial, patch, overlap, message):
    for module in (tsw, jsw):
        with pytest.raises(ValueError, match=message):
            module.grid_locations(spatial, patch, overlap)


@pytest.mark.parametrize("mode", ["average", "hann"])
@pytest.mark.parametrize("output_labels", [False, True])
def test_sliding_window_matches_jax_padded_program(mode, output_labels):
    """18 locations in batches of 4: JAX pads the last batch with weight-0
    copies, the port runs it short."""
    volume = np.random.default_rng(3).normal(size=(2, 12, 10, 9)).astype(np.float32)
    kwargs = dict(patch_size=(6, 6, 6), patch_overlap=(2, 3, 3), patch_batch=4, mode=mode,
                  output_labels=output_labels)
    assert len(tsw.grid_locations((12, 10, 9), (6, 6, 6), (2, 3, 3))) % 4 == 2
    ref = np.asarray(jsw.sliding_window_inference(volume, _jax_model, **kwargs))
    out = tsw.sliding_window_inference(torch.from_numpy(volume), _port_model, **kwargs).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if not output_labels:
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
        return
    probs = tsw.sliding_window_inference(torch.from_numpy(volume), _port_model,
                                         **dict(kwargs, output_labels=False)).numpy()
    top2 = np.sort(probs, axis=0)[-2:]
    clear = top2[1] - top2[0] > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(out[clear], ref[clear])


def test_last_batch_short_equals_one_batch():
    """The sums do not depend on how the locations are batched."""
    volume = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 12, 10, 9))
                              .astype(np.float32))
    outs = [tsw.sliding_window_inference(volume, _port_model, (6, 6, 6), (2, 3, 3), batch)
            for batch in (1, 4, 18)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
