"""The port's ``detect_tags_robust_staged`` against the JAX ladder, on the
CPU, on the synthetic scenes of ``tests/test_torch_robust.py`` (easy
frames plus a blank one, the ROI escalation pair, the 6-of-8 wave batch,
stage B's waves).

Tolerances (as stated in ``tests/test_torch_robust.py``): ids and valid
exact in every slot; corners and centres of valid slots within 0.5 px,
because the scenes' tags are pixel-replicated renders whose edge-refiner
peaks tie across whole plateaus (ROADMAP section C); each frame's
expected id found, and none on the blank frames.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu.core.config import DetectorConfig as JConfig  # noqa: E402
from repas_tpu.detect import robust as JR  # noqa: E402
from repas_tpu_torch.core.config import DetectorConfig  # noqa: E402
from repas_tpu_torch.detect import robust as TR  # noqa: E402
from test_torch_robust import CFG, EXPECTED, SCENES, _assert_same  # noqa: E402

from jax_departures import jax_detector_departures  # noqa: E402,F401
from torch_threads import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread",
                                     "jax_detector_departures")


@pytest.fixture(scope="module")
def staged_refs():
    """The JAX ladder's output per scene, computed once per module."""
    return {name: JR.detect_tags_robust_staged(np.stack(frames),
                                               JConfig(**CFG))
            for name, frames in SCENES.items()}


@pytest.mark.parametrize("name", list(SCENES))
def test_staged_ladder_vs_reference(name, staged_refs):
    got = TR.detect_tags_robust_staged(torch.from_numpy(np.stack(
        SCENES[name])), DetectorConfig(**CFG))
    _assert_same(got, staged_refs[name], corner_tol=0.5)
    for i, want in enumerate(EXPECTED[name]):
        found = got.ids[i][got.valid[i]].tolist()
        assert (want in found) if want is not None else not found, \
            (name, i, found)
