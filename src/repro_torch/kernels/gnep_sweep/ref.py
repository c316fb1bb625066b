"""Plain PyTorch version of the GNEP RM candidate-price sweep (P5 inner loop).

Given ``inc`` (Nc candidate prices x N classes, already permuted into
p-descending greedy order) and the slack capacity ``spare``, compute for each
candidate row the greedy knapsack fill, its total, and its p-weighted total.
The p-weighted total is an elementwise product and a sum, not a matrix
product, so no TF32 setting can reach it.
"""
import torch


def reference(inc, spare, p_sorted):
    """inc: (Nc, N); spare: scalar; p_sorted: (N,).

    Returns (fill (Nc,N), sum_fill (Nc,), p_fill (Nc,))."""
    cum = torch.cumsum(inc, dim=1)
    fill = torch.minimum(torch.clamp(spare - (cum - inc), min=0.0), inc)
    return fill, fill.sum(dim=1), (fill * p_sorted).sum(dim=1)


def reference_batched(inc, spare, p_sorted):
    """inc: (B, Nc, N); spare: (B,); p_sorted: (B, N).

    Returns (fill (B,Nc,N), sum_fill (B,Nc), p_fill (B,Nc))."""
    cum = torch.cumsum(inc, dim=-1)
    fill = torch.minimum(
        torch.clamp(spare[:, None, None] - (cum - inc), min=0.0), inc)
    return (fill, fill.sum(dim=-1),
            (fill * p_sorted[:, None, :]).sum(dim=-1))
