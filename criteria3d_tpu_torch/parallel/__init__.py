"""Domain decomposition over a ('row', 'col') mesh of devices."""
