"""Dense layers in the reference's (d_in, d_out) layout."""
