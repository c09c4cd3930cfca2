"""Ray-tiled volumetric rendering."""
