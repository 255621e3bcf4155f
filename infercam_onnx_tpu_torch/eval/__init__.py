"""Golden-detection checks and the parity metrics behind them."""
