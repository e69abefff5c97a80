"""Recommender models of the port: MIND's serving side."""
