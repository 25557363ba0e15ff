"""Host-placement learner loop, collection, evaluation and metrics."""
