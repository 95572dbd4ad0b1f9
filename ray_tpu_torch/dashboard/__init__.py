"""Dashboard pieces the single-node runtime starts (metrics history, node logs)."""
