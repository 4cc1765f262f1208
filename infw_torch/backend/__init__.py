"""Classifier backends of the port."""
