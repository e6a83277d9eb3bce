"""The fused ASP KAN-spline kernels (B1 pipeline layer, B3 single layer)."""
