"""Model code of the port: layers and the stage-based language model."""
