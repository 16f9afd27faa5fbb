"""Evaluation CLI of the PyTorch port, with the flags of `langsplat_tpu/cli/eval_cli.py`
plus --device:

    python -m langsplat_tpu_torch.cli.eval_cli --dataset_name teatime \
        --feat_dir output --ae_ckpt_dir ckpt --json_folder lerf_ovs/label \
        --text_embeddings prompts.npz [--no_vis] [--device cpu]

Reads the three feature levels the render CLI wrote
(`<feat_dir>/<dataset>_{1,2,3}/train/ours_<iteration>/renders_npy/*.npy`), the
autoencoder checkpoint (`<ae_ckpt_dir>/<dataset>/best_ckpt.npz`, else
`.../<dataset>/ae_ckpt/best_ckpt.npz`) and the labelme GT of
`<json_folder>/<dataset>`; decodes, scores the prompts and reports mIoU and
localization accuracy, logging to `<output_dir>/<dataset>/<timestamp>.log`. The prompt
embeddings come from --text_embeddings when it is given, else from the CLIP text
encoder loaded from --clip_model (a local checkpoint directory; default
`evaluation.clip_text.DEFAULT_MODEL`), as in the JAX CLI. It runs on the CUDA card
unless --device says otherwise, and fails without a card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

DECODE_CHUNK = 1 << 18   # rows per decoder call: ~0.27 GB for a 256-wide hidden layer


def make_decoder(model):
    """[N, 3] -> [N, 512] through `model.decode`, DECODE_CHUNK rows at a time, so that
    a hidden layer never holds a full-width frame's L*H*W rows (2.4M at 1024x768)."""
    import torch

    @torch.no_grad()
    def decode_fn(z):
        return torch.cat([model.decode(z[i:i + DECODE_CHUNK])
                          for i in range(0, z.shape[0], DECODE_CHUNK)])
    return decode_fn


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="open-vocab IoU + localization eval")
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--feat_dir", type=str, required=True)
    parser.add_argument("--ae_ckpt_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="eval_result")
    parser.add_argument("--json_folder", type=str, required=True)
    parser.add_argument("--mask_thresh", type=float, default=0.4)
    parser.add_argument("--encoder_dims", nargs="+", type=int,
                        default=[256, 128, 64, 32, 3])
    parser.add_argument("--decoder_dims", nargs="+", type=int,
                        default=[16, 32, 64, 128, 256, 256, 512])
    parser.add_argument("--clip_model", type=str, default=None,
                        help="local CLIP checkpoint directory of the text encoder "
                             "(default: clip_text.DEFAULT_MODEL); unused with "
                             "--text_embeddings")
    parser.add_argument("--text_embeddings", type=str, default=None,
                        help="npz of precomputed prompt embeddings (wins over "
                             "--clip_model)")
    parser.add_argument("--iteration", type=str, default="None",
                        help="render iteration in the feat dir layout")
    parser.add_argument("--no_vis", action="store_true",
                        help="skip heatmap/composited/localization artifacts")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run on the "
                             "CPU)")
    args = parser.parse_args(argv)

    from langsplat_tpu_torch.cli.autoencoder_cli import load_ae_checkpoint
    from langsplat_tpu_torch.device import float32_matmul_highest, resolve_device
    from langsplat_tpu_torch.evaluation import clip_text
    from langsplat_tpu_torch.evaluation.iou_loc import evaluate

    device = resolve_device(args.device)
    float32_matmul_highest()
    if args.text_embeddings:
        encode_text = clip_text.PrecomputedTextEncoder(args.text_embeddings)
    else:
        encode_text = clip_text.ClipTextEncoder(
            args.clip_model or clip_text.DEFAULT_MODEL, device=device)
    feat_dirs = [os.path.join(args.feat_dir, f"{args.dataset_name}_{i}",
                              "train", f"ours_{args.iteration}", "renders_npy")
                 for i in range(1, 4)]
    json_folder = os.path.join(args.json_folder, args.dataset_name)
    ae_ckpt = os.path.join(args.ae_ckpt_dir, args.dataset_name, "best_ckpt.npz")
    if not os.path.exists(ae_ckpt):
        ae_ckpt = os.path.join(args.ae_ckpt_dir, args.dataset_name, "ae_ckpt",
                               "best_ckpt.npz")

    output_path = os.path.join(args.output_dir, args.dataset_name)
    os.makedirs(output_path, exist_ok=True)
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    logger = logging.getLogger(args.dataset_name)
    logger.setLevel(logging.INFO)
    handlers = [logging.StreamHandler(),
                logging.FileHandler(os.path.join(output_path, f"{timestamp}.log"), "w")]
    for handler in handlers:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(handler)

    model = load_ae_checkpoint(ae_ckpt, args.encoder_dims, args.decoder_dims).to(device)
    try:
        return evaluate(feat_dirs, json_folder, make_decoder(model), encode_text,
                        mask_thresh=args.mask_thresh, logger=logger.info,
                        output_path=None if args.no_vis else output_path, device=device)
    finally:
        for handler in handlers:
            logger.removeHandler(handler)
            handler.close()


if __name__ == "__main__":
    main(sys.argv[1:])
