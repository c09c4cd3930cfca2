"""Scenes: the procedural synthetic scenes and dataset dispatch."""
