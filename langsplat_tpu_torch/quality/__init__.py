"""The end-to-end quality protocol of the PyTorch port (`scripts/quality_run.py` on the
port): the synthetic scene with known semantics (`scene.py`), OpenCV's polygon
extraction in numpy for its labelme ground truth (`contours.py`), and the stages, the
report and the entry point `python -m langsplat_tpu_torch.quality.run` (`run.py`).
"""
