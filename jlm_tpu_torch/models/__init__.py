"""LSTM LM functions and the parameter bridge."""
