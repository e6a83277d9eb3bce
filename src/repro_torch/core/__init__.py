"""The paper's quantized KAN datapath: B-splines, ASP quantization, layers,
deployment."""
