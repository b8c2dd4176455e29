"""AdamW with global-norm clipping and the LR schedule of the port."""
