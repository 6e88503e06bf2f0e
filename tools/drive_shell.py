"""Scripted end-to-end drive of the interactive web shell.

This container has no Chrome, so this client speaks exactly the page's
protocol (io_host/server.py's embedded JS): it consumes the MJPEG
``/stream`` multipart, POSTs the same ``/drag`` JSON a pointer-drag
produces, and measures the drag -> visible-vortex latency (first streamed
frame whose pixels moved near the drag path).  Frames before/after are
written for visual inspection.

  python tools/drive_shell.py --port 8123 [--out shell_out]
"""

import argparse
import io
import json
import time
import urllib.request


def read_mjpeg_frames(url, timeout=30.0):
    """Yield (t_received, jpeg_bytes) from a multipart MJPEG stream."""
    resp = urllib.request.urlopen(url, timeout=timeout)
    ctype = resp.headers.get("Content-Type", "")
    boundary = ctype.split("boundary=")[-1].encode()
    buf = b""
    while True:
        chunk = resp.read(4096)
        if not chunk:
            return
        buf += chunk
        while True:
            hdr_end = buf.find(b"\r\n\r\n")
            if hdr_end < 0:
                break
            hdr = buf[:hdr_end].decode(errors="replace")
            clen = None
            for line in hdr.split("\r\n"):
                if line.lower().startswith("content-length:"):
                    clen = int(line.split(":")[1])
            if clen is None:
                break
            body_start = hdr_end + 4
            if len(buf) < body_start + clen:
                break
            yield time.time(), buf[body_start:body_start + clen]
            buf = buf[body_start + clen:]
            nb = buf.find(boundary)
            if nb >= 0:
                buf = buf[nb + len(boundary):]


def decode(jpeg):
    from PIL import Image
    import numpy as np
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"),
                      dtype=np.int16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--out", default="shell_out")
    args = ap.parse_args()
    import os
    import numpy as np
    os.makedirs(args.out, exist_ok=True)
    base = f"http://{args.host}:{args.port}"

    stats = json.load(urllib.request.urlopen(base + "/stats", timeout=10))
    print("stats:", stats)

    # verify the MJPEG multipart framing (what the <img src="/stream"> tag
    # consumes) — 3 well-formed frames is the protocol check
    stream = read_mjpeg_frames(base + "/stream")
    for _ in range(3):
        _, jpeg0 = next(stream)
    mjpeg_ok = jpeg0[:2] == b"\xff\xd8" or jpeg0[:2] == b"P6"
    stream.close()

    ref = decode(jpeg0)
    with open(f"{args.out}/before.jpg", "wb") as f:
        f.write(jpeg0)

    def get_frame():
        return urllib.request.urlopen(base + "/frame", timeout=10).read()

    # drag a diagonal across the middle, as ~16 ms pointer moves (the JS
    # sends one /drag per pointermove with normalized coords)
    t_drag = time.time()
    n_seg = 8
    for k in range(n_seg):
        a = (0.30 + 0.40 * k / n_seg, 0.35)
        b = (0.30 + 0.40 * (k + 1) / n_seg, 0.35)
        req = urllib.request.Request(
            base + "/drag",
            data=json.dumps({"from": list(a), "to": list(b),
                             "ms": 16}).encode(),
            method="POST")
        urllib.request.urlopen(req, timeout=10).read()

    # latency: first frame whose pixels changed materially vs the baseline
    # in the dragged region (the sim is a fixed point until the drag, so
    # any regional delta is the drag's vortex)
    H, W = ref.shape[:2]
    reg = (slice(int(0.20 * H), int(0.55 * H)),
           slice(int(0.20 * W), int(0.80 * W)))
    latency = None       # pipeline: first latest-frame with ANY change
    visible = None       # fluid: the swirl is plainly visible
    frames = 0
    last = None
    t_end = time.time() + 8.0
    while time.time() < t_end:
        jpeg = get_frame()
        t = time.time()
        frames += 1
        img = decode(jpeg)
        # changed-PIXEL counts, not region-mean deltas: at production
        # grids the drag vortex is a tiny fraction of the streamed region,
        # so a mean threshold tuned at 61x81 never fires (round 4)
        changed = (np.abs(img[reg] - ref[reg]) > 15).any(axis=-1).sum()
        if latency is None and changed > 50:
            latency = t - t_drag
            with open(f"{args.out}/first_response.jpg", "wb") as f:
                f.write(jpeg)
        if visible is None and changed > 2000:
            visible = t - t_drag
        last = jpeg
    with open(f"{args.out}/after.jpg", "wb") as f:
        f.write(last)

    stats = json.load(urllib.request.urlopen(base + "/stats", timeout=10))
    print(json.dumps({
        "mjpeg_stream_ok": mjpeg_ok,
        "drag_to_first_change_ms": (round(latency * 1e3, 1)
                                    if latency else None),
        "drag_to_plain_swirl_ms": (round(visible * 1e3, 1)
                                   if visible else None),
        "frames_polled": frames,
        "steps_done": stats["steps"],
        "queue_dropped": stats["queue_dropped"],
        # producer/consumer pipeline health (round 4: encode off the sim
        # thread; sim_fps is completed device steps, encode_fps the JPEG
        # consumer's rate; dropped = latest-wins frames the encoder skipped)
        "sim_fps": stats.get("sim_fps"),
        "encode_fps": stats.get("encode_fps"),
        "frames_dropped": stats.get("frames_dropped"),
        "stream_decim": stats.get("stream_decim"),
    }))


if __name__ == "__main__":
    main()
