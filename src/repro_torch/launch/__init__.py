"""Command-line entry points of the port, and the step builders of its
training and serving paths (``steps``)."""
