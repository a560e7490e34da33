"""Model code of the port: layers, the SSM blocks and the stage-based
language model."""
