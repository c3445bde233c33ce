"""Work of `ops/preprocess.preprocess`, the per-Gaussian projection, per
step or view: one forward per render, one backward per train step.

Bytes, from the function's arguments at their dtypes, each read or
written once: in xyz 3, scale 3, quat 4, opacity 1, SH 3K, normal 3,
offset 1 float32 and alive 1 byte per row, the camera's 140 bytes; out
the Splats2D fields, 13 floats and 6 int32 per row.  The backward reads
the six differentiable inputs ((14 + 3K) floats) and the five float
cotangents (12 floats), and writes the six gradients.  Float ops per row
(fixed, per SH coefficient), counted from the projection's arithmetic:
forward (390, 7), backward (970, 16)."""
FWD_OPS, BWD_OPS = (390, 7), (970, 16)
CAMERA_BYTES = 140


def count(work: dict) -> dict:
    P, K = work["P"], work["K"]
    n_fwd = len(work["blends"])
    n_bwd = 1 if work["kind"] == "train" else 0
    fwd_bytes = P * ((15 + 3 * K) * 4 + 1 + 13 * 4 + 6 * 4) + CAMERA_BYTES
    bwd_bytes = P * ((14 + 3 * K) * 4 * 2 + 12 * 4) + CAMERA_BYTES
    return {"ops": n_fwd * P * (FWD_OPS[0] + FWD_OPS[1] * K)
            + n_bwd * P * (BWD_OPS[0] + BWD_OPS[1] * K),
            "bytes": n_fwd * fwd_bytes + n_bwd * bwd_bytes}
