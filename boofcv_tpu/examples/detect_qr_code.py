"""Render and detect QR codes in an image.

Reference analog: examples/fiducial/ExampleDetectQrCode.java +
ExampleRenderQrCode.java — generate a QR, embed it in a scene, detect
position patterns, sample the grid, decode the message.
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu.examples import setup_backend


def main(argv=None) -> int:
    setup_backend(argv)
    from boofcv_tpu.recognition.qr import code as qr, detector

    rng = np.random.default_rng(10)
    messages = ["BoofCV on GPU", "hello 12345"]
    decoded = []
    for i, msg in enumerate(messages):
        mat = qr.encode(msg, 2, "M", 3)
        img = detector.render(mat, module_px=4)
        scene = np.full((260, 280), 200.0, np.float32)
        y0, x0 = 30 + 10 * i, 40 + 15 * i
        scene[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
        scene += rng.normal(0, 2, scene.shape)
        data, info = detector.detect_and_decode(scene)
        text = data.decode() if isinstance(data, (bytes, bytearray)) \
            else data
        decoded.append(text)
        print(f"scene {i}: decoded {text!r}")
    ok = decoded == messages
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
