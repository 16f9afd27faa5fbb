#!/bin/bash
# The full LangSplat pipeline on the PyTorch port, on the CUDA card: process.sh
# (language features, autoencoder, phase A, phases B 1-3, render) and eval/eval.sh.
# Usage:
#   dataset_path=data/sofa casename=sofa sam_model=<local SAM dir> \
#   clip_model=<local CLIP dir> gt_folder=data/lerf_ovs/label bash process_torch.sh
# The SAM and CLIP checkpoints are local `transformers` directories; nothing is fetched.
# The synthetic end-to-end check of the same pipeline, with no weights or data:
#   python -m langsplat_tpu_torch.quality.run --ws <dir>
set -e
: "${dataset_path:?}" "${casename:?}" "${sam_model:?}" "${clip_model:?}" "${gt_folder:?}"

# 1. language features (SAM masks at four granularities, a CLIP embedding per mask)
python -m langsplat_tpu_torch.cli.preprocess_cli --dataset_path "$dataset_path" \
    --sam_model "$sam_model" --clip_model "$clip_model"

# 2. scene-wise autoencoder: 512-d -> 3-d codes
python -m langsplat_tpu_torch.cli.autoencoder_cli \
    --dataset_path "$dataset_path" --dataset_name "$casename" \
    --encoder_dims 256 128 64 32 3 --decoder_dims 16 32 64 128 256 256 512 --lr 0.0007
python -m langsplat_tpu_torch.cli.autoencoder_cli test \
    --dataset_path "$dataset_path" --dataset_name "$casename"

# 3. RGB 3DGS pretraining (phase A)
python -m langsplat_tpu_torch.cli.train_cli -s "$dataset_path" -m "output/${casename}" \
    --no_include_feature

# 4. language features per SAM granularity level (phase B)
for level in 1 2 3; do
    python -m langsplat_tpu_torch.cli.train_cli -s "$dataset_path" \
        -m "output/${casename}" --feature_level "${level}" \
        --start_checkpoint "output/${casename}_-1/chkpnt30000.npz"
done

# 5. render RGB + language features
for level in 1 2 3; do
    python -m langsplat_tpu_torch.cli.render_cli -m "output/${casename}_${level}" \
        -s "$dataset_path"
    python -m langsplat_tpu_torch.cli.render_cli -m "output/${casename}_${level}" \
        -s "$dataset_path" --include_feature
done

# 6. open-vocabulary IoU + localization eval (eval/eval.sh)
python -m langsplat_tpu_torch.cli.eval_cli --dataset_name "$casename" \
    --feat_dir output --ae_ckpt_dir ckpt --output_dir eval_result --mask_thresh 0.4 \
    --encoder_dims 256 128 64 32 3 --decoder_dims 16 32 64 128 256 256 512 \
    --json_folder "$gt_folder" --clip_model "$clip_model"
