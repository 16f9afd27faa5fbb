"""Work counts of SAM's automatic mask generation (the cell preprocess.sam-vit-h),
counted by hand from the configuration's widths: FP32 operations are 2 x the
multiply-adds of the matrix products, convolutions and attention; the elementwise work
(LayerNorm, GELU, softmax, the logits' bilinear upsampling, stability) is not counted,
so each count is a floor. Bytes count the weights and the input read once and the
output written once.

The image encoder of one 1024^2 crop at SAM ViT-H's widths (D 1280, 64 x 64 = 4,096
tokens, MLP 5,120, 16 heads of 80, windows of 14 on the grid padded to 70 x 70 = 4,900
tokens in 25 windows of 196, whose qkv and output projections run on the padded
tokens), layer by layer, in multiply-adds:

    patch embedding  4,096 x 768 x 1,280                        4,026,531,840
    windowed block   qkv + proj 4 x 4,900 x 1,280^2           32,112,640,000
                     MLP 2 x 4,096 x 1,280 x 5,120            53,687,091,200
                     q.k and p.v 25 x 16 x 2 x 196^2 x 80      2,458,624,000
                     q.R_h + q.R_w 4,900 x 16 x 2 x 14 x 80      175,616,000
                     one block                                88,433,971,200
                     x 28                                  2,476,151,193,600
    global block     qkv + proj 4 x 4,096 x 1,280^2           26,843,545,600
                     MLP                                      53,687,091,200
                     q.k and p.v 16 x 2 x 4,096^2 x 80        42,949,672,960
                     q.R_h + q.R_w 4,096 x 16 x 2 x 64 x 80      671,088,640
                     one block                               124,151,398,400
                     x 4                                     496,605,593,600
    neck             1x1 4,096 x 1,280 x 256 + 3x3 4,096 x 256^2 x 9
                                                               3,758,096,384
    total                                                  2,980,541,415,424

that is 5.96 TFLOP a crop (the 2.58 T multiply-adds of the blocks' linear layers on
the unpadded tokens alone, plus 0.15 T for the padding).
"""

from __future__ import annotations

from bench_port.counts import FP32_OPS_PER_S, HBM_BYTES_PER_S, Work  # noqa: F401

F32 = 4


def widths(cfg: dict) -> dict:
    d, heads = cfg["encoder_embed_dim"], cfg["encoder_num_heads"]
    g = cfg["image_size"] // cfg["patch_size"]
    win = cfg["window_size"]
    return dict(d=d, heads=heads, hd=d // heads, g=g, win=win,
                padded=-(-g // win) * win, mlp=int(d * cfg["mlp_ratio"]),
                p=cfg["patch_size"], depth=cfg["encoder_depth"],
                n_global=len(cfg["encoder_global_attn_indexes"]),
                c=cfg["prompt_embed_dim"], dec_depth=cfg["decoder_depth"],
                dec_mlp=cfg["decoder_mlp_dim"],
                inner=cfg["prompt_embed_dim"] // cfg["attention_downsample_rate"],
                masks=cfg["num_multimask_outputs"] + 1,
                iou_hidden=cfg["iou_head_hidden_dim"], iou_depth=cfg["iou_head_depth"])


def _block_macs(w: dict, tokens: int, side: int, n_windows: int) -> int:
    """One encoder block: qkv and output projections on `tokens` (the padded grid for a
    windowed block), the MLP on the grid, attention over `n_windows` windows of
    side^2 tokens, and the relative-position terms."""
    d, n = w["d"], w["g"] ** 2
    linear = 4 * tokens * d * d + 2 * n * d * w["mlp"]
    attention = n_windows * w["heads"] * 2 * (side * side) ** 2 * w["hd"]
    rel = tokens * w["heads"] * 2 * side * w["hd"]
    return linear + attention + rel


def encoder_macs(cfg: dict) -> int:
    w = widths(cfg)
    g, d, c, pad, win = w["g"], w["d"], w["c"], w["padded"], w["win"]
    patch = g * g * 3 * w["p"] ** 2 * d
    windowed = _block_macs(w, pad * pad, win, (pad // win) ** 2)
    global_ = _block_macs(w, g * g, g, 1)
    neck = g * g * d * c + g * g * c * c * 9
    return (patch + (w["depth"] - w["n_global"]) * windowed + w["n_global"] * global_
            + neck)


def encoder_params(cfg: dict) -> int:
    w = widths(cfg)
    d, g, c = w["d"], w["g"], w["c"]
    block = 4 * d + 4 * d * d + 4 * d + 2 * d * w["mlp"] + w["mlp"] + d
    rel = 2 * w["hd"] * ((w["depth"] - w["n_global"]) * (2 * w["win"] - 1)
                         + w["n_global"] * (2 * g - 1))
    return (3 * w["p"] ** 2 * d + d + g * g * d + w["depth"] * block + rel
            + d * c + 2 * c + 9 * c * c + 2 * c)


def encoder(cfg: dict) -> Work:
    """One crop's image encoder: the weights and the padded input read, the embedding
    written."""
    w = widths(cfg)
    side = cfg["image_size"]
    nbytes = F32 * (encoder_params(cfg) + 3 * side * side + w["c"] * w["g"] ** 2)
    return Work(nbytes, 2 * encoder_macs(cfg))


def decoder_prompt_macs(cfg: dict) -> int:
    """One prompt through the mask decoder: 7 tokens (IoU, 4 mask tokens, the point
    and its padding point) against the g^2 image tokens in the two-way transformer, the
    transposed-convolution upscaling of its own image tokens, the hypernetwork MLPs,
    the masks' dot products and the IoU head."""
    w = widths(cfg)
    t, n, c, inner = w["masks"] + 3, w["g"] ** 2, w["c"], w["inner"]
    self_attn = 4 * t * c * c + 2 * t * t * c
    token_to_image = t * c * inner + 2 * n * c * inner + 2 * t * n * inner + t * inner * c
    image_to_token = n * c * inner + 2 * t * c * inner + 2 * n * t * inner + n * inner * c
    layer = self_attn + token_to_image + 2 * t * c * w["dec_mlp"] + image_to_token
    transformer = w["dec_depth"] * layer + token_to_image
    g2 = 2 * w["g"]
    upscale = g2 * g2 * (c // 4) * c + (2 * g2) ** 2 * (c // 8) * (c // 4)
    hyper = w["masks"] * (2 * c * c + c * (c // 8))
    masks = w["masks"] * (c // 8) * (2 * g2) ** 2
    dims = [c] + [w["iou_hidden"]] * (w["iou_depth"] - 1) + [w["masks"]]
    iou = sum(a * b for a, b in zip(dims, dims[1:]))
    return transformer + upscale + hyper + masks + iou


def decoder_batch(cfg: dict, prompts: int) -> Work:
    """One batch of prompts: the embedding read, the low-res logits and IoU predictions
    of the 3 multimask outputs written."""
    w = widths(cfg)
    low = (4 * w["g"]) ** 2
    nbytes = F32 * (w["c"] * w["g"] ** 2 + prompts * (w["masks"] - 1) * (low + 1))
    return Work(nbytes, 2 * prompts * decoder_prompt_macs(cfg))


def view(cfg: dict, crops: int, prompts: int) -> Work:
    """One `generate`: `crops` encoder passes and `prompts` decoded prompts."""
    enc, dec = encoder(cfg), decoder_batch(cfg, prompts)
    return Work(crops * enc.nbytes + dec.nbytes, crops * enc.ops + dec.ops)
