"""zlib + numpy PNG codec (io/png.py): round trips for the TUM frame
formats under every filter type, and agreement with the native
decoder and with PIL."""

import numpy as np
import pytest

from cvo_rgbd_tpu.io.png import decode_png, encode_png, read_png, write_png

FILTERS = [0, 1, 2, 3, 4]


def _rgb8(rng, h=13, w=17):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _depth16(rng, h=11, w=19):
    d = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    d[0, :3] = [0, 1, 65535]          # byte-order edge values
    return d


@pytest.mark.parametrize("filter_type", FILTERS)
def test_png_round_trip_rgb8(rng, filter_type):
    img = _rgb8(rng)
    out = decode_png(encode_png(img, filter_type))
    assert out.dtype == np.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("filter_type", FILTERS)
def test_png_round_trip_depth16(rng, filter_type):
    img = _depth16(rng)
    out = decode_png(encode_png(img, filter_type))
    assert out.dtype == np.uint16 and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


def test_png_rejects_unsupported_arrays():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        decode_png(b"not a png")


@pytest.mark.parametrize("filter_type", [1, 4])
def test_png_native_decoder_agrees(rng, tmp_path, filter_type):
    """The native loader's decoder reads what this writer writes."""
    from cvo_rgbd_tpu import native

    if native.get_lib() is None:
        pytest.skip(f"native library unavailable: {native.build_error()}")
    rgb, dep = _rgb8(rng), _depth16(rng)
    write_png(tmp_path / "c.png", rgb, filter_type)
    write_png(tmp_path / "d.png", dep, filter_type)
    np.testing.assert_array_equal(native.decode_png(str(tmp_path / "c.png")),
                                  rgb)
    np.testing.assert_array_equal(native.decode_png(str(tmp_path / "d.png")),
                                  dep)


def test_png_pil_interop(rng, tmp_path):
    """Files PIL writes decode here (PIL chooses its own filters), and
    files written here open in PIL."""
    Image = pytest.importorskip("PIL.Image")
    rgb = _rgb8(rng, 32, 40)
    Image.fromarray(rgb).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), rgb)
    dep = _depth16(rng)
    write_png(tmp_path / "ours.png", dep, 4)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "ours.png")), dep
    )


def test_frame_loader_without_native(tmp_path, monkeypatch):
    """With no native library the driver decodes with io/png.py."""
    from cvo_rgbd_tpu import native
    from cvo_rgbd_tpu.io.tum import AssocEntry
    from cvo_rgbd_tpu.odometry import load_image_pair, make_frame_source

    rng = np.random.default_rng(0)
    rgb, dep = _rgb8(rng), _rgb8(rng)[..., 0].astype(np.uint16) * 100
    write_png(tmp_path / "c.png", rgb)
    write_png(tmp_path / "d.png", dep)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    e = AssocEntry("0.0", "c.png", "d.png")
    r, d = load_image_pair(str(tmp_path), e)
    assert r.dtype == np.float32 and d.dtype == np.float32
    np.testing.assert_array_equal(r, rgb)
    np.testing.assert_array_equal(d, dep)
    (i, r2, d2), = list(make_frame_source(str(tmp_path), [e], 0))
    assert i == 0
    np.testing.assert_array_equal(r2, r)
