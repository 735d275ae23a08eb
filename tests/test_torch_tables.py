"""The port's state carried across from the JAX package: the tag36h11
codebook, the rotation permutations and the config tree."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repas_tpu.core import config as jcfg  # noqa: E402
from repas_tpu.detect import tag_families as jtf  # noqa: E402
from repas_tpu_torch.core import config as tcfg  # noqa: E402
from repas_tpu_torch.detect import tag_families as ttf  # noqa: E402


def test_codebook_equals_reference():
    assert list(ttf.TAG36H11_CODES) == list(jtf.TAG36H11_CODES)
    assert len(ttf.TAG36H11_CODES) == ttf.FAMILY_SIZE == 587
    np.testing.assert_array_equal(ttf.tag_family_bits(),
                                  jtf.tag_family_bits())
    np.testing.assert_array_equal(ttf.rotation_perms(), jtf.rotation_perms())
    assert ttf.rotation_perms().dtype == jtf.rotation_perms().dtype


@pytest.mark.parametrize("tag_id", [0, 9, 16, 586])
def test_code_to_bits_equals_reference(tag_id):
    code = ttf.TAG36H11_CODES[tag_id]
    np.testing.assert_array_equal(ttf.code_to_bits(code),
                                  jtf.code_to_bits(code))


def _knobs(cfg):
    return {name: dataclasses.asdict(getattr(cfg, name))
            for name in ("detector", "pnp", "depth", "icp", "ransac", "crop",
                         "cad")} | {
        "tag_ids": tuple(cfg.tag_ids), "anchor_id": cfg.anchor_id}


@pytest.mark.parametrize("changed", [False, True])
def test_from_reference_round_trip(changed):
    ref = jcfg.PipelineConfig()
    if changed:
        ref = dataclasses.replace(
            ref,
            detector=dataclasses.replace(ref.detector, max_components=16,
                                         ccl_iters=3, quad_decimate=1.0),
            pnp=dataclasses.replace(ref.pnp, tag_size_m=0.05),
            depth=dataclasses.replace(ref.depth, center_win=7),
            icp=dataclasses.replace(ref.icp, max_iters=30, rel_tol=1e-5),
            ransac=dataclasses.replace(ref.ransac, hypothesis_batch=1024),
            crop=dataclasses.replace(ref.crop, dx_front=0.1, tag_ids=(5,),
                                     pad_m=0.01),
            cad=dataclasses.replace(ref.cad, flip_z_tag_ids=(9, 3)),
            tag_ids=(1, 2, 3), anchor_id=2)
    port = tcfg.from_reference(dataclasses.asdict(ref))
    assert isinstance(port, tcfg.PipelineConfig)
    assert _knobs(port) == _knobs(ref)
    if not changed:
        assert port == tcfg.PipelineConfig()


def test_precision_policy_is_full_f32():
    import repas_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
