"""The port's plots (``ppi_tpu_torch/viz.py``) against ``ppi_tpu/viz.py``:
each ``plot_*`` writes its file, and the data of every line and filled
band it draws equal JAX's on the same inputs (the port's given as torch
tensors, JAX's as numpy). Bound: exact equality of the drawn arrays."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_helpers  # noqa: E402,F401  (sets torch threads)
from ppi_tpu import viz as jviz  # noqa: E402
from ppi_tpu_torch import viz  # noqa: E402
from ppi_tpu_torch.utils import plotting  # noqa: E402

RNG = np.random.default_rng(0)
TRACE = {"mean": (np.exp(-np.arange(12) / 4.0) + 0.5).astype(np.float32),
         "std": RNG.random(12).astype(np.float32),
         "kl": RNG.random(12).astype(np.float32) + 0.1,
         "mu": RNG.random((12, 3)).astype(np.float32)}
SPECTRUM = RNG.random(16).astype(np.float32)
CASES = {
    "plot_algorithm_result": ((TRACE,), {"label": "Reps"}),
    "plot_mean_std_1d": ((RNG.standard_normal(20).astype(np.float32),
                          RNG.random(20).astype(np.float32)), {}),
    "plot_policy_samples": ((RNG.standard_normal((6, 9, 3))
                             .astype(np.float32),), {"d_viz": 2}),
    "plot_sequence": ((RNG.standard_normal((15, 4)).astype(np.float32),),
                      {}),
    "plot_samples": ((RNG.standard_normal((10, 5)).astype(np.float32),), {}),
    "plot_sequence_history": ((RNG.standard_normal(8).astype(np.float32),
                               RNG.standard_normal((8, 5, 4))
                               .astype(np.float32)), {}),
    "plot_smoothness": ((SPECTRUM, np.linspace(0, 25, 16, dtype=np.float32),
                         RNG.random(30).astype(np.float32)), {}),
    "plot_expert_data": (({"actions": RNG.standard_normal((40, 3))
                           .astype(np.float32),
                           "rewards": RNG.standard_normal(40)
                           .astype(np.float32),
                           "episode_length": 20},), {}),
}


def _tensors(x):
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def _drawn(fig):
    """Per axes: its lines' (x, y) data, its filled bands' vertices and its
    title and y scale."""
    out = []
    for ax in fig.axes:
        out.append(([np.asarray(ln.get_xydata()) for ln in ax.lines],
                    [np.asarray(p.vertices) for c in ax.collections
                     for p in c.get_paths()],
                    ax.get_title(), ax.get_yscale()))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_draws_jax_data_and_writes_its_file(name, tmp_path):
    args, kw = CASES[name]
    jfig = getattr(jviz, name)(*args, **kw)
    fig = getattr(viz, name)(*_tensors(args), **kw)
    try:
        want, got = _drawn(jfig), _drawn(fig)
        assert len(got) == len(want)
        for (gl, gc, gt, gs), (wl, wc, wt, ws) in zip(got, want):
            assert (gt, gs) == (wt, ws)
            assert len(gl) == len(wl) and len(gc) == len(wc)
            for g, w in zip(gl + gc, wl + wc):
                np.testing.assert_array_equal(g, w)
    finally:
        plt.close(jfig)
        plt.close(fig)
    getattr(viz, name)(*_tensors(args), filename=tmp_path / name, **kw)
    assert (tmp_path / f"{name}.png").stat().st_size > 1000


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_without_matplotlib_writes_a_png(name, tmp_path, monkeypatch):
    """On a machine without matplotlib (the card's) the plots go through
    the port's PIL stand-in and still write a non-blank PNG."""
    from PIL import Image
    monkeypatch.setattr(viz, "_plt", lambda: plotting.RASTER)
    args, kw = CASES[name]
    getattr(viz, name)(*_tensors(args), filename=tmp_path / name, **kw)
    img = np.asarray(Image.open(tmp_path / f"{name}.png"))
    assert img.ndim == 3 and img.shape[-1] == 3
    assert (img < 250).any(axis=-1).mean() > 0.005
