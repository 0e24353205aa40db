"""Closed-loop evaluation on the centroidal model: the batched
Monte-Carlo push study (`monte_carlo`) and its metrics (`metrics`)."""
