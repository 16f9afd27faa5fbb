"""Language-feature preprocessing of the PyTorch port (`process.sh` step 1): SAM masks
at four granularities, mask NMS, CLIP tiles and the `<image>_{f,s}.npy` files."""
