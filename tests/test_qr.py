"""QR subsystem oracles: RS codec, symbol encode/decode round-trips,
damage tolerance."""

import random

import numpy as np
import pytest

from boofcv_tpu.recognition.qr.reed_solomon import ReedSolomon
from boofcv_tpu.recognition.qr import code as qr


def test_reed_solomon_corrects_to_capacity():
    rs = ReedSolomon(16)
    rng = random.Random(0)
    for trial in range(50):
        msg = [rng.randrange(256) for _ in range(30)]
        c = msg + rs.encode(msg)
        for p in rng.sample(range(len(c)), rng.randrange(0, 9)):
            c[p] ^= rng.randrange(1, 256)
        dec, _ = rs.decode(c)
        assert dec is not None and dec[:30] == msg


def test_reed_solomon_rejects_overload():
    rs = ReedSolomon(8)
    msg = list(range(20))
    c = msg + rs.encode(msg)
    for p in range(6):
        c[p] ^= 0xAA
    dec, ne = rs.decode(c)
    assert dec is None or dec[:20] != msg  # must not silently mis-decode


@pytest.mark.parametrize("version,level", [(1, "L"), (2, "M"), (3, "Q"),
                                           (4, "H"), (5, "Q"), (7, "M"),
                                           (10, "L")])
def test_qr_roundtrip(version, level):
    cap = qr.data_capacity_bytes(version, level)
    text = ("boofcv-jax! " * 40)[: max(cap - 5, 1)]
    for mask in (0, 3, 7):
        mat = qr.encode(text, version, level, mask)
        out, info = qr.decode(mat)
        assert out is not None, info
        assert out.decode("utf8") == text
        assert info["mask"] == mask and info["level"] == level


def test_qr_decode_with_damage():
    text = "damage tolerance test"
    mat = qr.encode(text, version=3, level="H", mask=2)
    rng = np.random.default_rng(0)
    m = mat.copy()
    # flip ~4% of data modules
    n = m.shape[0]
    flips = 0
    while flips < int(n * n * 0.04):
        r, c = rng.integers(9, n - 9, 2)
        m[r, c] = ~m[r, c]
        flips += 1
    out, info = qr.decode(m)
    assert out is not None and out.decode("utf8") == text
    assert info["errors_corrected"] > 0


def test_qr_matrix_structure():
    mat = qr.encode("x", 2, "M", 0)
    n = mat.shape[0]
    assert n == 25
    # finder centers dark, timing alternates
    assert mat[3, 3] and mat[3, n - 4] and mat[n - 4, 3]
    row6 = mat[6, 8:n - 8]
    assert all(row6[i] == (i % 2 == 0) for i in range(len(row6)))


def test_qr_detect_and_decode_in_image():
    from boofcv_tpu.recognition.qr import detector
    text = "image localization"
    mat = qr.encode(text, version=2, level="M", mask=1)
    img = detector.render(mat, module_px=5)
    out, info = detector.detect_and_decode(img)
    assert out is not None, info
    assert out.decode("utf8") == text


def test_qr_detect_with_noise_and_offset():
    from boofcv_tpu.recognition.qr import detector
    rng = np.random.default_rng(1)
    text = "noisy"
    mat = qr.encode(text, version=1, level="Q", mask=5)
    img = detector.render(mat, module_px=6)
    big = np.full((img.shape[0] + 40, img.shape[1] + 60), 255.0, np.float32)
    big[17:17 + img.shape[0], 23:23 + img.shape[1]] = img
    big += rng.normal(0, 6, big.shape)
    out, info = detector.detect_and_decode(big)
    assert out is not None, info
    assert out.decode("utf8") == text


@pytest.mark.parametrize("version,level", [(11, "M"), (14, "Q"), (20, "L"),
                                           (26, "H"), (32, "M"), (40, "L")])
def test_qr_roundtrip_high_versions(version, level):
    """Versions beyond 10 (QrCode.java MAX_VERSION=40): block interleave,
    version-info BCH blocks, 16-bit byte counts."""
    cap = qr.data_capacity_bytes(version, level)
    text = ("high version payload / " * 400)[: max(cap - 8, 1)]
    mat = qr.encode(text, version, level, mask=4)
    assert mat.shape[0] == 4 * version + 17
    if version >= 7:
        assert qr.read_version_info(mat) == version
    out, info = qr.decode(mat)
    assert out is not None, info
    assert out.decode("utf8") == text
    assert info["version"] == version


def test_qr_numeric_mode():
    text = "01234567899876543210" * 3
    mat = qr.encode(text)  # auto mode -> numeric, auto version, auto mask
    out, info = qr.decode(mat)
    assert out is not None, info
    assert out.decode() == text
    # numeric packs ~3x denser than byte: must fit in a smaller symbol
    assert mat.shape[0] < qr.encode(text, mode=qr.MODE_BYTE).shape[0] \
        or mat.shape[0] == 21


def test_qr_alphanumeric_mode():
    text = "HELLO WORLD 123 $%*+-./:"
    mat = qr.encode(text, level="Q")
    out, info = qr.decode(mat)
    assert out is not None, info
    assert out.decode() == text


def test_qr_kanji_mode():
    text = "漢字テスト"  # kanji + katakana, SJIS 2-byte
    assert qr.select_mode(text) == qr.MODE_KANJI
    mat = qr.encode(text)
    out, info = qr.decode(mat)
    assert out is not None, info
    assert out.decode("utf8") == text


def test_qr_auto_version_selection():
    short = qr.encode("hi")
    assert short.shape[0] == 21  # version 1
    long = qr.encode("x" * 1200, level="L")
    v = (long.shape[0] - 17) // 4
    assert v >= 20
    out, _ = qr.decode(long)
    assert out.decode() == "x" * 1200


def test_qr_mask_auto_selection_penalty():
    mat = qr.encode("penalty-based mask", version=2, level="M")  # mask=None
    out, info = qr.decode(mat)
    assert out is not None and out.decode() == "penalty-based mask"
    # the chosen mask must be at least as good as every explicit mask
    pens = [qr.mask_penalty(qr.encode("penalty-based mask", 2, "M", m))
            for m in range(8)]
    assert qr.mask_penalty(mat) == min(pens)


def test_qr_detector_high_version():
    from boofcv_tpu.recognition.qr import detector
    text = "version estimation from finder geometry " * 3
    mat = qr.encode(text, version=12, level="M")
    img = detector.render(mat, module_px=4)
    out, info = detector.detect_and_decode(img)
    assert out is not None, info
    assert out.decode() == text
    assert info["version"] == 12
