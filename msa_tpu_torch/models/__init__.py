"""The MMBert model over plain tensor trees: encoder, heads and weights."""
