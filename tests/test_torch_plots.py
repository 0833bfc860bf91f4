"""The port's comparison figure (``aide_tpu_torch.evaluation.plots``) against aide_tpu's.

On the CPU: the same seeded image, ground truth and predictions through
both packages' ``save_comparison_figure`` give PNGs with the same decoded
pixels, for a 2-D and a 3-channel image, with and without titles.
matplotlib is imported only inside the function, in both packages."""

import numpy as np
import pytest

from aide_tpu.evaluation import plots as jplots

from aide_tpu_torch.evaluation import plots


@pytest.mark.parametrize("channels, titles", [(0, None), (3, ["net 1", "net 2"])],
                         ids=["gray_default_titles", "rgb_titles"])
def test_comparison_figure_matches_jax(tmp_path, channels, titles):
    import matplotlib.image

    rng = np.random.default_rng(0)
    shape = (24, 24, channels) if channels else (24, 24)
    image = rng.normal(size=shape).astype(np.float32)
    target = (rng.random((24, 24)) < 0.3).astype(np.uint8)
    preds = [(rng.random((24, 24)) < 0.3).astype(np.uint8) for _ in range(2)]
    paths = [str(tmp_path / name / "fig.png") for name in ("port", "jax")]
    plots.save_comparison_figure(paths[0], image, target, preds, titles)
    jplots.save_comparison_figure(paths[1], image, target, preds, titles)
    got, want = (matplotlib.image.imread(p) for p in paths)
    assert got.shape == want.shape == (300, 1200, 4)
    np.testing.assert_array_equal(got, want)
    assert got[..., :3].std() > 0
