"""Work of `models/aggregation` (the colour-fusion net), per step or view:
the multiply-adds of its two per-view dense layers (7 → d → d over the
visible sources) and its nine convolutions at their resolutions (full,
half and quarter size), counted as 2 ops each, under bf16 autocast as the
configuration states; a train step adds the backward's two products per
forward product (3x)."""


def forward_ops(d: int, H: int, W: int, views: int) -> int:
    h = d + 6
    full, half, quarter = H * W, (H // 2) * (W // 2), (H // 4) * (W // 4)
    convs = [(h, h, 3, full), (h, h // 2, 3, half), (h // 2, h // 4, 3,
                                                     quarter),
             (h // 4, h // 2, 3, half), (2 * (h // 2), h // 2, 3, half),
             (h // 2, h, 3, full), (2 * h, h, 3, full), (2 * h, h, 1, full),
             (h, 3, 1, full)]
    ops = sum(2 * cin * cout * k * k * n for cin, cout, k, n in convs)
    return ops + 2 * (7 * d + d * d) * views * full


def count(work: dict) -> dict:
    renders = sum(1 for b in work["blends"] if b["mode"] == "render_geo")
    f = forward_ops(work["net_width"], work["H"], work["W"],
                    work["visible"])
    return {"ops_bf16": renders * f * (3 if work["kind"] == "train" else 1)}
