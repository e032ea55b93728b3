"""Models: transformer blocks, BERT and the flax weight carrier."""
