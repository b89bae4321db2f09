"""Generate QR codes and read them back.

Reference analog: applications/CreateQrCodeDocument.java +
examples ExampleRenderQrCode — encode messages at several versions /
error-correction levels, render to an image "document", then detect and
decode every code from the composite image.
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu.examples import setup_backend


def main(argv=None) -> int:
    setup_backend(argv)
    from boofcv_tpu.recognition.qr import code as qr
    from boofcv_tpu.recognition.qr import detector

    messages = [("HELLO BOOFCV GPU", "M"),
                ("0123456789", "L"),
                ("https://example.org/a/b?c=1", "Q")]
    tiles = []
    for text, level in messages:
        mat = qr.encode(text, level=level)
        tiles.append(detector.render(mat, module_px=4))

    # paste onto one white document with margins
    hmax = max(t.shape[0] for t in tiles)
    wtot = sum(t.shape[1] for t in tiles) + 40 * (len(tiles) + 1)
    doc = np.full((hmax + 60, wtot, ), 255.0, np.float32)
    x = 40
    spots = []
    for t in tiles:
        doc[30:30 + t.shape[0], x:x + t.shape[1]] = t
        spots.append((x, t.shape[1], t.shape[0]))
        x += t.shape[1] + 40

    # scan the document region by region (the batch-scan app's flow:
    # one detect+decode per localized code)
    texts = []
    for x, tw, th in spots:
        crop = doc[:, max(x - 20, 0):x + tw + 20]
        data, info = detector.detect_and_decode(crop)
        if data is not None:
            texts.append(data.decode() if isinstance(data, (bytes,
                                                            bytearray))
                         else str(data))
    texts = sorted(texts)
    expect = sorted(m for m, _ in messages)
    print(f"document {doc.shape[1]}x{doc.shape[0]}, decoded "
          f"{len(texts)}/{len(messages)}: {texts}")
    ok = texts == expect
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
