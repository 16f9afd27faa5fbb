"""Open-vocabulary evaluation of the PyTorch port: relevancy, the LERF IoU and
localization protocol, colormaps and the visualization files."""
