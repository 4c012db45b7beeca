"""Input pipelines of the training path."""
