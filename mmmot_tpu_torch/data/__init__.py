"""Host-side KITTI readers and writers (numpy only)."""
