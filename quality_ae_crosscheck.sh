#!/bin/bash
# The quality protocol's autoencoder in both packages on one staged scene (ROADMAP F4):
#   1. stage the scene:  python -m langsplat_tpu_torch.quality.run --ws <ws> --stages scene
#   2. the JAX package's side, on the CPU:  bash quality_ae_crosscheck.sh jax <ws>
#      the JAX CLI's init (--num_epochs 0), its state after each of $EPOCHS epochs, the
#      protocol's 400-epoch checkpoint and scripts/quality_run.py's oracle of it, in
#      <ws>/jax_ae/
#   3. the port's side, on the card (device=cpu for the CPU):
#      bash quality_ae_crosscheck.sh port <ws>
#      python -m langsplat_tpu_torch.quality.ae_compare, into <ws>/ae_compare.json
set -e
part=${1:?jax or port}
ws=${2:?the workspace of a staged scene}
EPOCHS="1 10 50 100 200 400"
scene=synthroom
jax="$ws/jax_ae"

if [ "$part" = jax ]; then
    mkdir -p "$jax"
    ae() {  # ae <name> <flags...>: the JAX CLI into $jax/<name>.npz
        JAX_PLATFORMS=cpu python -m langsplat_tpu.cli.autoencoder_cli \
            --dataset_path "$ws/scene" --dataset_name "$scene" \
            --ckpt_root "$jax/ckpt_$1" "${@:2}"
        cp "$jax/ckpt_$1/$scene/best_ckpt.npz" "$jax/$1.npz"
    }
    ae init --num_epochs 0
    for e in $EPOCHS; do
        ae "e$e" --num_epochs "$e" --eval_from_frac 1.0
    done
    JAX_PLATFORMS=cpu python scripts/quality_run.py --ws "$ws" --stages ae,oracle
    cp "$ws/ckpt/$scene/best_ckpt.npz" "$jax/best.npz"
    cp "$ws/eval_oracle.json" "$jax/oracle.json"
else
    python -m langsplat_tpu_torch.quality.ae_compare --ws "$ws" --jax_dir "$jax" \
        --epochs $EPOCHS ${device:+--device "$device"}
fi
