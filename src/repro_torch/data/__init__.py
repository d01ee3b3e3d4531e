"""Host-side data: sparse COO container, synthetic datasets, design layouts."""
