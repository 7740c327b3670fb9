"""Loss arithmetic: the adversarial losses and the DAMSM matching losses."""
