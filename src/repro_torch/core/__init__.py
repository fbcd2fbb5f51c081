"""ThinkAir core (host side): clock, clones, dispatch, scheduling, venues."""
