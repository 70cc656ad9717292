"""Video decoding and frame delivery (host side)."""
