"""Ciphertext layouts, encryption, external product and decryption."""
