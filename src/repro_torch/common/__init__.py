"""Device resolution and parameter-tree helpers shared by the port."""
