"""Work counts of the mask-to-embedding stage (the cell embed.clip-vit-b16), counted by
hand from the configuration's widths: FP32 operations are 2 x the multiply-adds of the
matrix products (the patch embedding, the tower's linear layers and attention, the mask
NMS's pairwise product); the elementwise work (the normalisation, LayerNorm, GELU,
softmax, the tiles' resize, the seg map) is not counted, so each count is a floor.
Bytes count the weights read once a forward pass, the tiles read once and the
embeddings written once.

The image tower of one 224^2 tile at OpenCLIP ViT-B/16's widths (D 768, 14 x 14 = 196
patches and the class token, 197 tokens, 12 heads of 64, MLP 3,072, output 512), layer
by layer, in multiply-adds:

    patch embedding  196 x 768 x 768                              115,605,504
    block            qkv 197 x 768 x 2,304                        348,585,984
                     q.k and p.v 2 x 12 x 197^2 x 64               59,610,624
                     output projection 197 x 768^2                116,195,328
                     MLP 2 x 197 x 768 x 3,072                    929,562,624
                     one block                                  1,453,954,560
                     x 12                                      17,447,454,720
    projection       768 x 512                                        393,216
    total                                                      17,563,453,440

that is 35.13 GFLOP a tile; 86,192,640 parameters (345 MB in float32), so a pass of 64
tiles is bound by its operations (33.6 ms at 67 TFLOP/s against 0.11 ms for its bytes).
"""

from __future__ import annotations

from bench_port.counts import FP32_OPS_PER_S, HBM_BYTES_PER_S, Work  # noqa: F401

F32 = 4


def widths(cfg: dict) -> dict:
    v = cfg["vision_cfg"]
    d, g = v["width"], v["image_size"] // v["patch_size"]
    return dict(d=d, heads=d // v["head_width"], hd=v["head_width"], patches=g * g,
                tokens=g * g + 1, p=v["patch_size"], mlp=int(d * v["mlp_ratio"]),
                layers=v["layers"], out=cfg["embed_dim"], side=v["image_size"])


def tile_macs(cfg: dict) -> int:
    """One tile through the tower."""
    w = widths(cfg)
    d, t = w["d"], w["tokens"]
    patch = w["patches"] * 3 * w["p"] ** 2 * d
    block = (t * d * 3 * d + 2 * w["heads"] * t * t * w["hd"] + t * d * d
             + 2 * t * d * w["mlp"])
    return patch + w["layers"] * block + d * w["out"]


def params(cfg: dict) -> int:
    w = widths(cfg)
    d, m = w["d"], w["mlp"]
    block = 2 * d + 3 * d * d + 3 * d + d * d + d + 2 * d + d * m + m + m * d + d
    return (3 * w["p"] ** 2 * d + d + w["tokens"] * d + 2 * d + w["layers"] * block
            + 2 * d + d * w["out"])


def encoder_pass(cfg: dict, tiles: int) -> Work:
    """One forward pass of `tiles` tiles: the weights read, the tiles read, the
    embeddings written."""
    w = widths(cfg)
    nbytes = F32 * (params(cfg) + tiles * (3 * w["side"] ** 2 + w["out"]))
    return Work(nbytes, 2 * tiles * tile_macs(cfg))


def encoder(cfg: dict, tiles_per_level) -> Work:
    """Every level's tiles, `batch_size` a pass (a level's last pass partial)."""
    batch, total = cfg["batch_size"], Work(0, 0)
    for n in tiles_per_level:
        for start in range(0, n, batch):
            total = total + encoder_pass(cfg, min(batch, n - start))
    return total


def mask_nms(masks: int, pixels: int) -> Work:
    """One level's pairwise intersections, [M, HW] x [HW, M] in float32: the masks read
    as bool, the [M, M] counts written."""
    return Work(masks * pixels + F32 * masks * masks, 2 * masks * masks * pixels)


def view(cfg: dict, masks_per_level, tiles_per_level, pixels: int) -> Work:
    """One `embed_masks`: each level's mask NMS and every tile through the tower."""
    total = encoder(cfg, tiles_per_level)
    for m in masks_per_level:
        total = total + mask_nms(m, pixels)
    return total
