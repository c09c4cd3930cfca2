"""NeRFSmall and the radiance-field query."""
