"""The last pieces of modules ported earlier, against the JAX package's:
the codebook API of detect/tag_families.py (load, validate, install,
read back; the detector decoding under a swapped table),
detect_tags_batch, kernels/ccl.py's component_areas and
component_bboxes, and kernels/image.py's extract_patches.

Every output is held exactly equal: ids and valid flags under the same
codebook swap, the codebook lists and minimum distances, areas and boxes
of CCL labels of random masks (float32 counts and coordinates, +-inf for
absent labels), patches at random in-bounds starts, at starts past
the last fitting position (both packages clamp those) and at negative
starts (both count those from the end first).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repas_tpu.detect import detector as JDet, tag_families as JT  # noqa: E402
from repas_tpu.kernels import ccl as JC, image as JI  # noqa: E402
from repas_tpu_torch.core.config import DetectorConfig  # noqa: E402
from repas_tpu_torch.detect import (detect_tags, detect_tags_batch,  # noqa: E402
                                    tag_families as TT)
from repas_tpu_torch.detect.render import render_tag_in_scene  # noqa: E402
from repas_tpu_torch.kernels import ccl as TC, image as TI  # noqa: E402
from test_torch_stream_scenes import one_torch_thread  # noqa: E402

SUBSET = slice(5, 105)      # tag 9 -> id 4, tag 16 -> id 11, tag 150 gone


def _scene():
    """240x320 frame with tags 9, 16 and 150, fronto-parallel."""
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    img = np.full((240, 320), 180.0, np.float32)
    for tid, x in ((9, -0.13), (16, 0.0), (150, 0.13)):
        g = render_tag_in_scene(tid, np.eye(3), np.array([x, 0.0, 0.45]), K,
                                0.06, (240, 320), supersample=2)
        img = np.where(g != 180.0, g, img)
    noise = np.random.default_rng(4).normal(0, 2, (240, 320))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _port_ids(gray):
    t = detect_tags(torch.from_numpy(gray)[None], DetectorConfig())
    return t.ids[0].numpy(), t.valid[0].numpy()


def test_codebook_swap_changes_decoding_as_reference():
    gray = _scene()
    tid, tv = _port_ids(gray)                   # also fills the table cache
    assert sorted(tid[tv].tolist()) == [9, 16, 150]
    sub = TT.load_codebook()[SUBSET]
    try:
        JT.set_active_codebook(sub)
        TT.set_active_codebook(sub)
        assert TT.active_codebook() == JT.active_codebook() == sub
        assert TT.tag_family_bits().shape == (100, 36)
        j = jax.jit(lambda g: JDet.detect_tags(g, JDet.DetectorConfig()))(
            jnp.asarray(gray))
        tid, tv = _port_ids(gray)
        assert np.array_equal(np.asarray(j.ids), tid)
        assert np.array_equal(np.asarray(j.valid), tv)
        assert sorted(tid[tv].tolist()) == [4, 11]
    finally:
        for mod in (JT, TT):
            mod.set_active_codebook(mod.TAG36H11_CODES)
            mod._ACTIVE_CODES = None
    assert TT.active_codebook() == list(TT.TAG36H11_CODES)
    tid, tv = _port_ids(gray)
    assert sorted(tid[tv].tolist()) == [9, 16, 150]


def test_load_and_validate_codebook_match_reference(tmp_path):
    codes = TT.TAG36H11_CODES
    (tmp_path / "t.c").write_text("static const uint64_t codes[] = {\n"
                                  + ",\n".join(f"   0x{c:016x}UL"
                                               for c in codes[:40]) + "};\n")
    (tmp_path / "t.txt").write_text("# decimal\n" + "\n".join(
        str(c) for c in codes[40:60]) + "\n\n")
    for src in (None, str(tmp_path / "t.c"), str(tmp_path / "t.txt"),
                codes[:30], np.asarray(codes[:30], np.uint64)):
        a, b = JT.load_codebook(src), TT.load_codebook(src)
        assert a == b and all(type(x) is int for x in b)
    with open(tmp_path / "t.txt") as f:
        assert TT.load_codebook(f) == codes[40:60]
    with pytest.raises(ValueError, match="out of 36-bit range"):
        TT.load_codebook([1 << 36])
    assert TT.validate_codebook(codes) == JT.validate_codebook(codes) == 11
    assert TT.validate_codebook(codes[:50]) == JT.validate_codebook(codes[:50])
    bad = [codes[0], codes[0] ^ 0b111]               # 3 bits apart
    for mod in (JT, TT):
        with pytest.raises(ValueError, match="violates min hamming"):
            mod.validate_codebook(bad)
        with pytest.raises(ValueError):
            mod.set_active_codebook(bad)
    assert TT._ACTIVE_CODES is None


def test_detect_tags_batch_is_detect_tags():
    gray = np.stack([_scene(), _scene()[:, ::-1].copy()])
    with one_torch_thread():
        a = detect_tags_batch(torch.from_numpy(gray))
        b = detect_tags(torch.from_numpy(gray))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape,density", [((37, 53), 0.4), ((64, 80), 0.6),
                                           ((1, 9), 0.5)])
def test_component_areas_and_bboxes_match_reference(shape, density):
    rng = np.random.default_rng(shape[0])
    masks = rng.random((3, *shape)) < density
    masks[2] = False                                  # no component at all
    for m in masks:
        lab = np.asarray(JC.connected_components(jnp.asarray(m), iters=5))
        lt = torch.from_numpy(lab.copy())
        a_j = np.asarray(JC.component_areas(jnp.asarray(lab)))
        a_t = TC.component_areas(lt).numpy()
        assert a_t.dtype == np.float32 and np.array_equal(a_j, a_t)
        assert a_t.sum() == m.sum()
        for x, y in zip(JC.component_bboxes(jnp.asarray(lab)),
                        TC.component_bboxes(lt)):
            assert np.array_equal(np.asarray(x), y.numpy())
    # batched labels give each image's own result
    lab = np.stack([np.asarray(JC.connected_components(jnp.asarray(m), 5))
                    for m in masks])
    batched = TC.component_bboxes(torch.from_numpy(lab))
    for i in range(3):
        one = TC.component_bboxes(torch.from_numpy(lab[i].copy()))
        assert all(torch.equal(b[i], o) for b, o in zip(batched, one))


def test_extract_patches_matches_reference():
    rng = np.random.default_rng(7)
    img = rng.random((40, 60)).astype(np.float32)
    ph, pw = 12, 16
    starts = np.stack([rng.integers(0, 60 - pw + 1, 20),
                       rng.integers(0, 40 - ph + 1, 20)], 1).astype(np.int32)
    starts[:3] = [[55, 35], [60, 0], [0, 39]]        # past the last fit
    a = np.asarray(JI.extract_patches(jnp.asarray(img), jnp.asarray(starts),
                                      (ph, pw)))
    b = TI.extract_patches(torch.from_numpy(img), torch.from_numpy(starts),
                           (ph, pw)).numpy()
    assert b.shape == (20, ph, pw) and np.array_equal(a, b)
    # a negative start counts from the end, as dynamic_slice takes it
    neg = np.array([[-3, -5], [-1, -1], [-70, -50]], np.int32)
    a = np.asarray(JI.extract_patches(jnp.asarray(img), jnp.asarray(neg),
                                      (ph, pw)))
    b = TI.extract_patches(torch.from_numpy(img), torch.from_numpy(neg),
                           (ph, pw)).numpy()
    assert np.array_equal(a, b)
