"""Host-side data loading and transforms of the port."""
