"""Host-side input: video decode, face boxes and landmarks (numpy/cv2)."""
