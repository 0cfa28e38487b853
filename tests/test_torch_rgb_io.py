"""The port's image IO and geometry (``eas_snn_tpu_torch/data/image.py``
and its host core ``data/imgcore/imgcore.cpp``) against cv2, bit for
bit: ``imread`` on JPEGs that ``cv2.imwrite`` writes here (qualities 50,
75 and 95; sampling 4:4:4, 4:2:2, 4:4:0 and 4:2:0; odd sizes; grey;
restart intervals; optimized Huffman tables; progressive), on PIL JPEGs
with EXIF orientations, PIL CMYK JPEGs (baseline and progressive, and the
same files marked YCCK), on PNG bytes under a ``.jpg`` name and on PNGs
that ``cv2.imwrite`` writes (every compression level and row filter,
RGBA, grey) and PIL writes (grey + alpha, 1- to 8-bit palettes); the
refusals (a truncated progressive file, truncated, not an image);
``resize_linear_u8``,
``warp_affine_u8`` (both the core and the numpy plain versions) and
``rotation_matrix_2d`` at the mosaic's and mixup's sizes with matrices
drawn by the JAX package's ``_affine_matrix``; the core's build and its
raise; the checked-in fixtures that ``chip_smoke.py`` phase 15a reads
on the card, regenerated here with cv2 (and PIL) and found unchanged.

``python tests/test_torch_rgb_io.py --write-fixtures`` rewrites the
fixtures (JPEGs and a PNG by cv2, a CMYK JPEG by PIL, cv2's decoded
pixels as PNGs by the port's lossless writer).
"""

import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from eas_snn_tpu_torch.data import image
from eas_snn_tpu_torch.ops import _build
from eas_snn_tpu_torch.utils.png import read_png, write_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "rgb")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _scene(h, w, seed, noise=12.0):
    """A smooth colour field with flat boxes and some noise, uint8 BGR."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / (5 + 3 * c) + c)
                    * np.cos(y / (4 + 2 * c) - c) for c in range(3)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, max(h - 4, 1)), rng.integers(0, max(w - 4, 1))
        img[y0:y0 + rng.integers(3, h // 2 + 4),
            x0:x0 + rng.integers(3, w // 2 + 4)] = rng.integers(0, 256, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _flat_scene(h, w, seed):
    """Flat boxes on a flat background (compresses well as a PNG)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), (90, 120, 150), np.uint8)
    for _ in range(12):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        img[y0:y0 + rng.integers(30, h // 3),
            x0:x0 + rng.integers(30, w // 3)] = rng.integers(0, 256, 3)
    return img


def _write(path, img, params):
    assert cv2.imwrite(path, img, params)
    return path


# --------------------------------------------------------------- imread

@pytest.mark.parametrize("size", [(47, 61), (120, 160), (9, 17)])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_imread_equals_cv2(tmp_path, quality, sampling, size):
    h, w = size
    img = _scene(h, w, quality + h)
    p = _write(str(tmp_path / "a.jpg"), img,
               [cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    want = cv2.imread(p)
    got = image.imread(p)
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("size", [(47, 61), (120, 160), (9, 17)])
def test_imread_grey_jpeg(tmp_path, size):
    """A one-component JPEG comes back as three equal channels."""
    g = _scene(*size, seed=3)[..., 1]
    p = _write(str(tmp_path / "g.jpg"), g, [cv2.IMWRITE_JPEG_QUALITY, 80])
    got = image.imread(p)
    assert got.shape == size + (3,)
    assert np.array_equal(got, cv2.imread(p))
    assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("flag,value", [
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1), (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1)])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_imread_restarts_and_optimized_tables(tmp_path, flag, value,
                                              sampling):
    img = _scene(83, 101, 7, noise=40.0)
    p = _write(str(tmp_path / "r.jpg"), img,
               [flag, value, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                SAMPLING[sampling]])
    assert np.array_equal(image.imread(p), cv2.imread(p))


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_imread_exif_orientation(tmp_path, orientation):
    """PIL JPEGs with an EXIF orientation: turned as cv2.imread turns
    them (its default IMREAD_COLOR applies the tag)."""
    from PIL import Image

    img = _scene(37, 53, orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    p = str(tmp_path / "e.jpg")
    Image.fromarray(img[..., ::-1]).save(p, exif=exif.tobytes(), quality=90)
    want = cv2.imread(p)
    assert want.shape == ((53, 37, 3) if orientation in (6, 8)
                          else (37, 53, 3))
    assert np.array_equal(image.imread(p), want)


def test_imread_png_under_a_jpg_name(tmp_path):
    """The file's signature decides, as in cv2: PNG bytes named .jpg (a
    grey one too) read through the PNG reader."""
    img = _scene(30, 41, 1)
    p = str(tmp_path / "x.jpg")
    write_png(p, img)
    assert np.array_equal(image.imread(p), cv2.imread(p))
    write_png(p, img[..., 0])
    got = image.imread(p)
    assert got.shape == (30, 41, 3)
    assert np.array_equal(got, cv2.imread(p))


def test_imread_refusals_name_the_file_and_mode(tmp_path):
    """A progressive file cut short (cv2 fills the missing scans and
    warns), a baseline one cut short, a BMP under a .jpg name."""
    img = _scene(40, 56, 2)
    prog = _write(str(tmp_path / "prog.jpg"), img,
                  [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = open(prog, "rb").read()
    with open(prog, "wb") as f:
        f.write(data[: len(data) * 9 // 10])
    assert cv2.imread(prog) is not None
    with pytest.raises(ValueError, match=r"prog\.jpg.*truncated"):
        image.imread(prog)
    full = _write(str(tmp_path / "full.jpg"), img, [])
    data = open(full, "rb").read()
    cut = str(tmp_path / "cut.jpg")
    with open(cut, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match=r"cut\.jpg.*truncated"):
        image.imread(cut)
    bmp = str(tmp_path / "b.jpg")
    cv2.imwrite(str(tmp_path / "b.bmp"), img)
    shutil.copy(str(tmp_path / "b.bmp"), bmp)
    with pytest.raises(ValueError, match=r"b\.jpg.*not a JPEG or a PNG"):
        image.imread(bmp)


def test_imread_refuses_cmyk_and_12_bit(tmp_path):
    """A CMYK JPEG (PIL writes one) cut short, and a 12-bit frame header.
    (Whole CMYK files read: ``test_imread_cmyk_and_ycck_equal_cv2``.)"""
    from PIL import Image

    p = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_cmyk(16, 16, 0), "CMYK").save(p)
    assert image.imread(p).shape == (16, 16, 3)
    data = open(p, "rb").read()
    open(p, "wb").write(data[: len(data) - 40])
    with pytest.raises(ValueError, match=r"cmyk\.jpg.*truncated"):
        image.imread(p)
    data = bytearray(open(_write(str(tmp_path / "a.jpg"),
                                 _scene(16, 16, 0), []), "rb").read())
    sof = data.index(b"\xff\xc0")
    data[sof + 4] = 12  # the frame's sample precision
    p = str(tmp_path / "p12.jpg")
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=r"p12\.jpg.*12-bit"):
        image.imread(p)


# ------------------------------------------------ progressive, CMYK, PNG

def _cmyk(h, w, seed):
    """A CMYK image: the scene's inverted channels and a noisy K."""
    k = np.random.default_rng(seed).integers(0, 256, (h, w, 1), np.uint8)
    return np.concatenate([255 - _scene(h, w, seed), k], -1)


@pytest.mark.parametrize("size", [(47, 61), (9, 17)])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_imread_progressive_equals_cv2(tmp_path, quality, sampling, size):
    """Progressive JPEGs (spectral selection and successive
    approximation: DC and AC first and refinement scans, end-of-band
    runs) by cv2.imwrite, at odd sizes."""
    h, w = size
    img = _scene(h, w, quality + w)
    p = _write(str(tmp_path / "p.jpg"), img,
               [cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert open(p, "rb").read().find(b"\xff\xc2") > 0  # SOF2
    assert np.array_equal(image.imread(p), cv2.imread(p))


def test_imread_progressive_grey_and_restarts(tmp_path):
    """A grey progressive file and one with restart intervals (the
    end-of-band run ends at each restart)."""
    g = _scene(37, 45, 4)[..., 0]
    p = _write(str(tmp_path / "g.jpg"), g, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert np.array_equal(image.imread(p), cv2.imread(p))
    p = _write(str(tmp_path / "r.jpg"), _scene(64, 80, 5, noise=30.0),
               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    assert np.array_equal(image.imread(p), cv2.imread(p))


@pytest.mark.parametrize("ycck", [False, True], ids=["cmyk", "ycck"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_imread_cmyk_and_ycck_equal_cv2(tmp_path, progressive, ycck):
    """PIL's CMYK JPEGs (Adobe transform 0, inverted CMYK), baseline and
    progressive; and the same files with the Adobe transform set to 2
    (YCCK: libjpeg turns the components back into CMYK), as no tool here
    writes YCCK."""
    from PIL import Image

    p = str(tmp_path / "c.jpg")
    Image.fromarray(_cmyk(37, 53, 9), "CMYK").save(p, quality=90,
                                                   progressive=progressive)
    data = bytearray(open(p, "rb").read())
    adobe = data.index(b"Adobe")
    assert data[adobe + 11] == 0
    if ycck:
        data[adobe + 11] = 2
        open(p, "wb").write(bytes(data))
    want = cv2.imread(p)
    assert want is not None and want.shape == (37, 53, 3)
    assert np.array_equal(image.imread(p), want)


@pytest.mark.parametrize("level", range(10))
def test_imread_cv2_png_equals_cv2(tmp_path, level):
    """cv2.imwrite's PNGs at every compression level (its adaptive row
    filters, several IDAT chunks)."""
    p = _write(str(tmp_path / "a.png"), _scene(97, 131, level),
               [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert np.array_equal(image.imread(p), cv2.imread(p))


@pytest.mark.parametrize("flt", ["NONE", "SUB", "UP", "AVG", "PAETH"])
def test_imread_png_row_filters_equal_cv2(tmp_path, flt):
    """Each of PNG's row filters alone (cv2's IMWRITE_PNG_FILTER)."""
    p = _write(str(tmp_path / "f.png"), _scene(53, 71, 3),
               [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_"
                                                   f"{flt}")])
    assert np.array_equal(image.imread(p), cv2.imread(p))


@pytest.mark.parametrize("kind", ["rgba", "grey", "grey_alpha", "p8", "p4",
                                  "p2", "p1", "pil_rgba"])
def test_imread_png_colour_types_equal_cv2(tmp_path, kind):
    """RGBA and grey by cv2; grey + alpha, 8/4/2/1-bit palettes and an
    optimized RGBA by PIL: cv2's IMREAD_COLOR drops the alpha and
    expands the palette."""
    from PIL import Image

    img = _scene(41, 59, 6)
    alpha = np.random.default_rng(6).integers(0, 256, (41, 59, 1), np.uint8)
    p = str(tmp_path / "c.png")
    if kind == "rgba":
        _write(p, np.concatenate([img, alpha], -1), [])
    elif kind == "grey":
        _write(p, img[..., 1], [])
    elif kind == "grey_alpha":
        Image.fromarray(np.concatenate([img[..., :1], alpha], -1),
                        "LA").save(p)
    elif kind == "pil_rgba":
        Image.fromarray(np.concatenate([img[..., ::-1], alpha], -1),
                        "RGBA").save(p, optimize=True)
    else:
        colors = {"p8": 200, "p4": 16, "p2": 4, "p1": 2}[kind]
        Image.fromarray(img[..., ::-1]).convert(
            "P", palette=Image.ADAPTIVE, colors=colors).save(p)
    got = image.imread(p)
    assert got.shape == (41, 59, 3)
    assert np.array_equal(got, cv2.imread(p))


# --------------------------------------------------------------- geometry

def _affine(seed, w, h, degrees=10.0, translate=0.1, scales=(0.1, 2.0),
            shear=2.0):
    from eas_snn_tpu.data.mosaic import _affine_matrix

    rng = np.random.default_rng(seed)
    return _affine_matrix(rng, degrees, translate, scales, shear, w, h)[0]


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (96, 128)), ((375, 500), (640, 853)), ((120, 160), (93, 124)),
    ((47, 61), (101, 77)), ((9, 17), (33, 5)), ((480, 640), (240, 320)),
    ((96, 128), (48, 64)), ((120, 160), (160, 213))])
def test_resize_equals_cv2(src, dst):
    """The mosaic's and mixup's resizes (min(h / ih, w / iw), times a
    jitter): up, down, odd sizes, and the exact halving (cv2's 2x2 box
    path)."""
    rng = np.random.default_rng(src[0] + dst[1])
    img = rng.integers(0, 256, src + (3,), np.uint8)
    oh, ow = dst
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(image.resize_linear_u8(img, (ow, oh)), want)
    assert np.array_equal(image.resize_linear_u8_plain(img, (ow, oh)), want)
    grey = img[..., 0].copy()
    want = cv2.resize(grey, (ow, oh), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(image.resize_linear_u8(grey, (ow, oh)), want)


@pytest.mark.parametrize("canvas,out,seed", [
    ((192, 256), (128, 96), 0), ((192, 256), (128, 96), 1),
    ((832, 832), (416, 416), 2), ((1280, 1280), (640, 640), 3),
    ((150, 170), (77, 61), 4), ((64, 64), (64, 64), 5)])
def test_warp_affine_equals_cv2(canvas, out, seed):
    """The mosaic's warp of its 2h x 2w canvas to (w, h), with matrices of
    the JAX package's ``_affine_matrix`` (rotation, scale 0.1-2, shear,
    translation), border 114; odd widths exercise cv2's scalar tail."""
    img = np.random.default_rng(seed).integers(0, 256, canvas + (3,),
                                               np.uint8)
    w, h = out
    M = _affine(seed, w, h)
    want = cv2.warpAffine(img, M, dsize=(w, h), borderValue=(114, 114, 114))
    assert np.array_equal(image.warp_affine_u8(img, M, (w, h)), want)
    assert np.array_equal(image.warp_affine_u8_plain(img, M, (w, h)), want)


def test_rotation_matrix_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(50):
        c = tuple(rng.uniform(-50, 50, 2))
        a, s = rng.uniform(-180, 180), rng.uniform(0.1, 2.0)
        assert np.array_equal(image.rotation_matrix_2d(c, a, s),
                              cv2.getRotationMatrix2D(c, a, s))


# --------------------------------------------------------------- the core

def test_core_builds_into_the_build_dir():
    lib = image.load_native()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libimgcore_")


def test_core_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "imgcore.cpp"
    bad.write_text(open(image._SRC).read() + "\nthis is not C++;\n")
    monkeypatch.setattr(image, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        image.load_native()


# --------------------------------------------------------------- fixtures

def _pil_cmyk(path, img):
    from PIL import Image

    Image.fromarray(img, "CMYK").save(path, quality=85)


def fixture_specs():
    """{file name: (image, cv2.imwrite params, or a writer(path, image))}
    of the checked-in images: JPEGs and a PNG by cv2, a CMYK JPEG by
    PIL."""
    q = cv2.IMWRITE_JPEG_QUALITY
    s = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    return {
        "q75_420_160x120.jpg": (_scene(120, 160, 11),
                                [q, 75, s, SAMPLING["420"]]),
        "q90_444_61x47.jpg": (_scene(47, 61, 12), [q, 90, s, SAMPLING["444"]]),
        "rst_422_96x80.jpg": (_scene(80, 96, 13),
                              [q, 85, s, SAMPLING["422"],
                               cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
        "grey_33x17.jpg": (_scene(17, 33, 14)[..., 2], [q, 80]),
        "scene_640x480.jpg": (_flat_scene(480, 640, 15),
                              [q, 75, s, SAMPLING["420"]]),
        "prog_420_75x53.jpg": (_scene(53, 75, 16),
                               [q, 80, s, SAMPLING["420"],
                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "cmyk_48x40.jpg": (_cmyk(40, 48, 17), _pil_cmyk),
        "filtered_83x61.cv2.png": (_scene(61, 83, 18, noise=4.0),
                                   [cv2.IMWRITE_PNG_COMPRESSION, 6]),
    }


def pixels_name(name: str) -> str:
    """The file of cv2's pixels of fixture ``name``: its stem + .png."""
    return name.split(".")[0] + ".png"


def write_fixtures(out_dir=FIXTURES):
    """Each image by cv2 (or PIL), and cv2.imread's pixels beside it as a
    PNG by the port's writer."""
    os.makedirs(out_dir, exist_ok=True)
    for name, (img, params) in fixture_specs().items():
        p = os.path.join(out_dir, name)
        if callable(params):
            params(p, img)
        else:
            _write(p, img, params)
        write_png(os.path.join(out_dir, pixels_name(name)), cv2.imread(p))


def test_fixtures_regenerate_unchanged(tmp_path):
    """cv2 (and PIL) write the same bytes and cv2 decodes the same pixels
    as the checked-in fixtures; the port reads each to its pixels; under
    250 KB."""
    write_fixtures(str(tmp_path))
    names = sorted(os.listdir(FIXTURES))
    assert names == sorted(os.listdir(tmp_path))
    inputs = sorted(fixture_specs())
    assert len(inputs) == 8 and set(inputs) <= set(names)
    assert len(names) == 2 * len(inputs)
    total = 0
    for n in names:
        data = open(os.path.join(FIXTURES, n), "rb").read()
        total += len(data)
        assert data == open(tmp_path / n, "rb").read(), n
    for n in inputs:
        want = read_png(os.path.join(FIXTURES, pixels_name(n)))
        want = want if want.ndim == 3 else np.repeat(want[..., None], 3, 2)
        assert np.array_equal(image.imread(os.path.join(FIXTURES, n)),
                              want), n
    assert total < 250_000


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
        print("wrote", FIXTURES)
