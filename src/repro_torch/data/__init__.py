"""Host-side (numpy) datasets."""
