"""Visualization renderers in numpy (port of oatx/visualization), with no PIL."""
