"""Launch-layer pieces of the port: the card's cost profile."""
